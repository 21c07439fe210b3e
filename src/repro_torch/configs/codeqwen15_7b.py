"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d_model=4096 32H (kv=32)
d_ff=13440 vocab=92416; qwen1.5 arch (attention bias, no qk_norm)."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, vocab=92416, vocab_pad_multiple=256,
        n_heads=32, n_kv_heads=32, head_dim=128, qk_norm=False,
        attn_bias=True, rope_theta=1e6, d_ff=13440,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16, attn_bias=True, d_ff=128,
        dtype=torch.float32,
    )
