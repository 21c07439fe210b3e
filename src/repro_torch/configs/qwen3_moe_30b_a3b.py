"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
expert d_ff=768, vocab=151936, MoE 128 experts top-8, qk_norm."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, vocab=151936, vocab_pad_multiple=256,
        n_heads=32, n_kv_heads=4, head_dim=128, qk_norm=True,
        rope_theta=1e6, d_ff=0,
        n_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.25,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
        n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=1.25,
        dtype=torch.float32,
    )
