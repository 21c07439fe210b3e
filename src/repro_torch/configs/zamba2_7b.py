"""zamba2-7b [arXiv:2411.15242]: 81 Mamba2 layers d_model=3584 + a SHARED
attention+MLP block (32H MHA, d_ff=14336) applied every 6 SSM layers with
per-site LoRA on the shared weights; ssm_state=64, vocab=32000.

The shared-attention sites decode over a ring of at most 4096 positions
(``hybrid_window``); the Mamba2 backbone keeps O(1) state."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, vocab=32000, vocab_pad_multiple=256,
        n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336,
        rope_theta=1e4,
        ssm_state=64, ssm_head_dim=64, ssm_groups=2, ssm_chunk=256,
        hybrid_attn_every=6, hybrid_window=4096,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=6, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        ssm_state=16, ssm_head_dim=16, ssm_groups=2, ssm_chunk=8,
        hybrid_attn_every=3, hybrid_window=32,
        dtype=torch.float32,
    )
