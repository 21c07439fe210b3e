"""qwen3-4b [hf:Qwen/Qwen3-4B]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, vocab=151936, vocab_pad_multiple=256,
        n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1e6, d_ff=9728,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True, d_ff=128,
        dtype=torch.float32,
    )
