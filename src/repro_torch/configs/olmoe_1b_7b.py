"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (kv=16) expert
d_ff=1024, vocab=50304, MoE 64 experts top-8, qk_norm."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, vocab=50304, vocab_pad_multiple=256,
        n_heads=16, n_kv_heads=16, head_dim=128, qk_norm=True,
        rope_theta=1e4,
        n_experts=64, top_k=8, d_ff_expert=1024, capacity_factor=1.25,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16, qk_norm=True,
        n_experts=4, top_k=2, d_ff_expert=32,
        dtype=torch.float32,
    )
