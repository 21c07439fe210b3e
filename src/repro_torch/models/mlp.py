"""SwiGLU / GELU MLP blocks.  PyTorch twin of ``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import QSpec, linear_apply, linear_init
from repro_torch.utils import scope

Tensor = torch.Tensor


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                dtype=torch.bfloat16, lora_rank: int = 0,
                device=None) -> dict:
    kw = dict(dtype=dtype, lora_rank=lora_rank, device=device)
    return {
        "gate": linear_init(gen, d_model, d_ff, **kw),
        "up": linear_init(gen, d_model, d_ff, **kw),
        "down": linear_init(gen, d_ff, d_model, **kw),
    }


def swiglu_apply(p, x: Tensor, qspec: QSpec | None = None) -> Tensor:
    with scope("gate"):
        g = linear_apply(p["gate"], x, qspec)
    with scope("up"):
        u = linear_apply(p["up"], x, qspec)
    h = F.silu(g.float()).to(x.dtype) * u
    with scope("down"):
        return linear_apply(p["down"], h, qspec)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                  dtype=torch.bfloat16, lora_rank: int = 0, bias: bool = True,
                  device=None) -> dict:
    kw = dict(dtype=dtype, bias=bias, lora_rank=lora_rank, device=device)
    return {"up": linear_init(gen, d_model, d_ff, **kw),
            "down": linear_init(gen, d_ff, d_model, **kw)}


def gelu_mlp_apply(p, x: Tensor, qspec: QSpec | None = None) -> Tensor:
    with scope("up"):
        h = linear_apply(p["up"], x, qspec)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    with scope("down"):
        return linear_apply(p["down"], h, qspec)
