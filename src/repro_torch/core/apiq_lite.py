"""ApiQ-lite: gradient-based per-layer ``(A, B)`` refinement baseline.

PyTorch twin of ``repro.core.apiq_lite``.  ApiQ (Liao et al., 2024)
optimizes the layer discrepancy by back-propagation; this lite variant is
the layer-wise flavour on the calibrated objective

    min_{A,B}  || X (Q + A B^T - W) ||_F^2
             = Tr((A B^T - dW)^T H (A B^T - dW)),    dW = W - Q,

with Adam on ``(A, B)`` for a fixed base ``Q``: the gradient-descent
counterpart of CLoQ's closed form.  The update is the JAX twin's own (β
0.9 / 0.999, bias correction, ε 1e-8, the objective divided by the
``trace(H) / m`` scale), written as tensor arithmetic with the gradient
from ``torch.autograd``.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def apiq_lite_init(H: Tensor, dW: Tensor, rank: int, steps: int = 200,
                   lr: float = 3e-3, seed: int = 0):
    """Adam on ``(A, B)`` minimizing ``Tr((A B^T - dW)^T H (A B^T -
    dW))`` from ``A`` drawn from a ``torch.Generator`` seeded with
    ``seed`` (scaled by ``1/sqrt(m)``) and ``B = 0``.

    Returns ``(A (m, r), B (n, r), trajectory)``: the objective before
    each step, ``(steps,)``."""
    m = dW.shape[0]
    gen = torch.Generator(device=dW.device)
    gen.manual_seed(seed)
    A0 = torch.randn((m, rank), generator=gen, dtype=torch.float32,
                     device=dW.device) / math.sqrt(m)
    return apiq_lite_from(H, dW, A0, steps, lr)


def apiq_lite_from(H: Tensor, dW: Tensor, A0: Tensor, steps: int = 200,
                   lr: float = 3e-3):
    """The Adam loop of :func:`apiq_lite_init` from a given initial ``A0
    (m, r)`` (``B`` starts at 0)."""
    H, dW = H.float(), dW.float()
    m, n = dW.shape
    scale = torch.sqrt(torch.clamp(torch.trace(H) / m, min=1e-6))
    params = [A0.float().clone(), torch.zeros((n, A0.shape[1]),
                                              dtype=torch.float32,
                                              device=dW.device)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    traj = []
    for i in range(steps):
        with torch.enable_grad():
            A, B = (p.requires_grad_(True) for p in params)
            D = A @ B.T - dW
            v = (D * (H @ D)).sum() / (scale ** 2)
            grads = torch.autograd.grad(v, (A, B))
        traj.append(v.detach())
        t = torch.tensor(i + 1.0, dtype=torch.float32, device=dW.device)
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        with torch.no_grad():
            for j, g in enumerate(grads):
                mu[j] = 0.9 * mu[j] + 0.1 * g
                nu[j] = 0.999 * nu[j] + 0.001 * g * g
                upd = (mu[j] / c1) / (torch.sqrt(nu[j] / c2) + 1e-8)
                params[j] = params[j].detach() - lr * upd
    A, B = (p.detach() for p in params)
    return A, B, torch.stack(traj) * (scale ** 2)
