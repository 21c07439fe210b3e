"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: 40L d_model=5120 32H
(GQA kv=8, head_dim=128) d_ff=14336 vocab=131072; mistral-nemo decoder
backbone.  The pixtral-ViT frontend is a stub: the data supplies 256
precomputed patch embeddings (``prefix_embeds``), prepended to the token
sequence."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="dense",
        n_layers=40, d_model=5120, vocab=131072, vocab_pad_multiple=256,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        rope_theta=1e6, frontend="vision", n_prefix=256,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        frontend="vision", n_prefix=8,
        dtype=torch.float32,
    )
