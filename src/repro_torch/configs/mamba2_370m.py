"""mamba2-370m [arXiv:2405.21060]: 48L d_model=1024, attention-free SSD,
ssm_state=128, vocab=50280 (padded).  d_inner=2048, 32 heads of dim 64."""
import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, vocab=50280, vocab_pad_multiple=256,
        ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_chunk=256,
        tie_embeddings=True,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        n_layers=3, d_model=64, vocab=512,
        ssm_state=16, ssm_head_dim=16, ssm_groups=1, ssm_chunk=8,
        tie_embeddings=True,
        dtype=torch.float32,
    )
