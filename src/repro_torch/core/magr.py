"""MagR preprocessing (Zhang et al., 2024): weight magnitude reduction.

PyTorch twin of ``repro.core.magr``.  Solves, per output column j of W
(y = X @ W convention):

    min_{W~}  ||X (W~ - W)||_F^2 + alpha * sum_j ||W~[:, j]||_inf

by proximal gradient descent.  The prox of ``t * ||.||_inf`` is
``v - proj_{l1-ball(t)}(v)`` (Moreau decomposition); the l1 projection
finds its soft threshold with an unrolled Newton ascent.  Every step acts
per output column given the Gram ``H``, for one matrix or for each matrix
of a bucket's stack.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import linalg

Tensor = torch.Tensor


def _per_slice(x: Tensor | float, like: Tensor) -> Tensor | float:
    """A per-matrix scalar (shape ``(L,)`` for a bucket's stack) shaped to
    broadcast against the per-column ``(L, n)`` quantities."""
    if isinstance(x, Tensor) and x.dim():
        return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))
    return x


def project_l1_ball(v: Tensor, radius: Tensor | float,
                    iters: int = 12) -> Tensor:
    """Project columns of v (..., m, n) onto the l1 ball of ``radius`` (a
    scalar, or one per matrix of the stack).

    Newton from ``theta = 0`` on ``g(theta) = sum_i max(|v_i| - theta, 0)
    - radius`` ascends monotonically to the soft-threshold level."""
    av = v.abs()
    l1 = av.sum(dim=-2)                                        # (..., n)
    radius = _per_slice(radius, l1)
    theta = torch.zeros_like(l1)
    for _ in range(iters):
        over = av > theta[..., None, :]
        s = torch.where(over, av - theta[..., None, :], 0.0).sum(dim=-2)
        cnt = over.to(av.dtype).sum(dim=-2).clamp_min(1.0)
        theta = (theta + (s - radius) / cnt).clamp_min(0.0)
    proj = torch.sign(v) * (av - theta[..., None, :]).clamp_min(0.0)
    return torch.where((l1 <= radius)[..., None, :], v, proj)


def prox_linf(v: Tensor, t: Tensor | float) -> Tensor:
    """prox_{t * ||.||_inf} applied per column (Moreau: v - P_{l1<=t}(v))."""
    return v - project_l1_ball(v, t)


def magr_alpha(H: Tensor, m: int) -> Tensor:
    """MagR regularization strength ``0.001 * tr(H) / m`` as a tensor (no
    host sync), one per matrix of a stack."""
    return 0.001 * linalg.trace(H) / m


def magr_preprocess(W: Tensor, H: Tensor, alpha: Tensor | float = 1e-3,
                    iters: int = 20) -> Tensor:
    """Return W~ with reduced per-column l-inf norm, calibrated against H.
    ``W (..., m, n)`` and ``H (..., m, m)``: one matrix or a bucket's stack
    (``alpha`` then a scalar or one per matrix)."""
    W = W.float()
    H = H.float()
    m = H.shape[-1]
    # Lipschitz constant of the smooth part: lambda_max(H), 16-step power
    # iteration
    v = torch.full(H.shape[:-1], 1.0 / math.sqrt(m), dtype=torch.float32,
                   device=H.device)
    for _ in range(16):
        v = _mv(H, v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    L = _dot(v, _mv(H, v)).clamp_min(1e-8)                  # (...,)
    t = alpha / L
    L, t = _per_slice(L, W), _per_slice(t, W[..., 0, :])
    Wt = W
    for _ in range(iters):
        G = H @ (Wt - W)
        Wt = prox_linf(Wt - G / L, t)
    return Wt


def _mv(H: Tensor, v: Tensor) -> Tensor:
    """``H @ v`` for each matrix of a stack (a matrix-vector product for
    one matrix, as in the 2-D call)."""
    return H @ v if H.dim() == 2 else (H @ v[..., None])[..., 0]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return a @ b if a.dim() == 1 else (a[..., None, :] @ b[..., None])[
        ..., 0, 0]
