"""MagR preprocessing (Zhang et al., 2024): weight magnitude reduction.

PyTorch twin of ``repro.core.magr``.  Solves, per output column j of W
(y = X @ W convention):

    min_{W~}  ||X (W~ - W)||_F^2 + alpha * sum_j ||W~[:, j]||_inf

by proximal gradient descent.  The prox of ``t * ||.||_inf`` is
``v - proj_{l1-ball(t)}(v)`` (Moreau decomposition); the l1 projection
finds its soft threshold with an unrolled Newton ascent.  Every step acts
per output column given the Gram ``H``.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def project_l1_ball(v: Tensor, radius: Tensor | float,
                    iters: int = 12) -> Tensor:
    """Project columns of v (m, n) onto the l1 ball of ``radius``.

    Newton from ``theta = 0`` on ``g(theta) = sum_i max(|v_i| - theta, 0)
    - radius`` ascends monotonically to the soft-threshold level."""
    av = v.abs()
    l1 = av.sum(dim=0)                                         # (n,)
    theta = torch.zeros(av.shape[1:], dtype=av.dtype, device=av.device)
    for _ in range(iters):
        over = av > theta[None, :]
        s = torch.where(over, av - theta[None, :], 0.0).sum(dim=0)
        cnt = over.to(av.dtype).sum(dim=0).clamp_min(1.0)
        theta = (theta + (s - radius) / cnt).clamp_min(0.0)
    proj = torch.sign(v) * (av - theta[None, :]).clamp_min(0.0)
    return torch.where(l1[None, :] <= radius, v, proj)


def prox_linf(v: Tensor, t: Tensor | float) -> Tensor:
    """prox_{t * ||.||_inf} applied per column (Moreau: v - P_{l1<=t}(v))."""
    return v - project_l1_ball(v, t)


def magr_alpha(H: Tensor, m: int) -> Tensor:
    """MagR regularization strength ``0.001 * tr(H) / m`` as a tensor (no
    host sync)."""
    return 0.001 * torch.trace(H) / m


def magr_preprocess(W: Tensor, H: Tensor, alpha: Tensor | float = 1e-3,
                    iters: int = 20) -> Tensor:
    """Return W~ with reduced per-column l-inf norm, calibrated against H."""
    W = W.float()
    H = H.float()
    m = H.shape[0]
    # Lipschitz constant of the smooth part: lambda_max(H), 16-step power
    # iteration
    v = torch.full((m,), 1.0 / math.sqrt(m), dtype=torch.float32,
                   device=H.device)
    for _ in range(16):
        v = H @ v
        v = v / (torch.linalg.norm(v) + 1e-30)
    L = (v @ (H @ v)).clamp_min(1e-8)
    t = alpha / L
    Wt = W
    for _ in range(iters):
        G = H @ (Wt - W)
        Wt = prox_linf(Wt - G / L, t)
    return Wt
