"""seamless-m4t-medium [arXiv:2308.11596]: encoder-decoder, 12L each side,
d_model=1024 16H d_ff=4096 vocab=256206 (padded).  The audio frontend is a
stub: the data supplies precomputed frame embeddings (``enc_embeds``, of
length seq_len // 4 in the train CLI); the decoder runs at seq_len.  As in
the JAX package, RMSNorm and RoPE stand in for LayerNorm and relative
positions."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, n_enc_layers=12, d_model=1024,
        vocab=256206, vocab_pad_multiple=256,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
        rope_theta=1e4, frontend="audio",
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, frontend="audio",
        dtype=torch.float32,
    )
