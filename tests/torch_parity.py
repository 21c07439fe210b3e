"""Helpers for the port's parity tests (``tests/test_torch_*.py``): the same
numpy inputs go through the JAX package and through ``repro_torch``, and
the outputs come back as numpy for comparison."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro_torch.convert import params_from_jax

# the reference's own kernel tolerances (tests/test_kernels.py:12-14)
TOL_F32 = dict(rtol=2e-4, atol=2e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def to_np(x) -> np.ndarray:
    """A torch tensor or JAX array as numpy; bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jax_params, port_cfg, device="cpu") -> dict:
    """JAX params carried into the port's tree on ``device``."""
    return params_from_jax(jax_to_numpy(jax_params), port_cfg, device)


def configs(**overrides):
    """(JAX config, port config) pair of the qwen3-1.7b smoke model."""
    from repro import configs as jc
    from repro_torch import configs as tc
    return (jc.get_smoke_config("qwen3-1.7b", **overrides),
            tc.get_smoke_config("qwen3-1.7b", **overrides))
