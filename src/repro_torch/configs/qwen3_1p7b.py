"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B]: 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, qk_norm."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, vocab=151936, vocab_pad_multiple=256,
        n_heads=16, n_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1e6, d_ff=6144,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True, d_ff=128,
        dtype=torch.float32,
    )
