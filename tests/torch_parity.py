"""Helpers for the port's parity tests (``tests/test_torch_*.py``): the same
numpy inputs go through the JAX package and through ``repro_torch``, and
the outputs come back as numpy for comparison.

Importing this module sets torch's intra-op threads once for the test
process: the machine's cores shared among pytest-xdist's workers
(``PYTEST_XDIST_WORKER_COUNT``; all of them without xdist).  Every
``tests/test_torch_*.py`` imports it, so that ``-n 6`` on 8 cores does not
run six workers of 8 threads each.  It imports ``jax`` only inside
:func:`jax_to_numpy`, so the card's tests (``test_torch_cuda.py``, run
where JAX is not installed) can import it too."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.convert import params_from_jax


def worker_threads() -> int:
    """Intra-op threads for one test process: the cores over the xdist
    worker count (1 without xdist), at least one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(worker_threads())

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
    import jax
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
