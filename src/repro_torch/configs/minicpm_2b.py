"""minicpm-2b [arXiv:2404.06395]: 40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753 (padded for TP), llama-like arch; trained with the WSD schedule
(``--schedule wsd`` of the train CLI)."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, vocab=122753, vocab_pad_multiple=256,
        n_heads=36, n_kv_heads=36, head_dim=64, qk_norm=False,
        rope_theta=1e4, d_ff=5760, tie_embeddings=True,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke", family="dense",
        n_layers=2, d_model=72, vocab=512,
        n_heads=6, n_kv_heads=6, head_dim=12, d_ff=144, tie_embeddings=True,
        dtype=torch.float32,
    )
