"""CLoQ (Theorem 3.1): closed-form calibrated LoRA initialization.

PyTorch twin of ``repro.core.cloq``.  Given
the regularized calibration Gram ``H = X^T X + lambda*I`` and the
quantization residual ``dW = W - Q``, the optimal rank-r adapters
minimizing ``|| X (A B^T - dW) ||_F^2`` are any factorization of
``R^{-1} LR_r(R dW)`` where ``R = S_H^{1/2} U_H^T`` is the non-symmetric
root of ``H`` (H = R^T R) and ``LR_r`` the best rank-r approximation.

Splits of ``A B^T = R^{-1} U_{:r} S_{:r} V_{:r}^T`` (paper Table 7):
    "paper" : A = R^{-1} U S,      B = V        (default)
    "bsigma": A = R^{-1} U,        B = V S
    "sqrt"  : A = R^{-1} U S^1/2,  B = V S^1/2

:func:`cloq_init_sharded` is the distributed variant: ``dW`` column-sharded
over the mesh's model axis, the SVD of ``R dW`` computed exactly through
the Gram trick (one ``m x m`` all-reduce a layer).  Its shard-local body
:func:`cloq_lowrank_local` also takes a bucket's stack ``(L, m, n_local)``,
whose ``(L, m, m)`` Grams go out in one all-reduce
(:func:`repro_torch.core.batched.run_bucket_sharded`).
"""
from __future__ import annotations

import torch

from repro_torch.core import linalg
from repro_torch.models import parallel

Tensor = torch.Tensor

SPLITS = ("paper", "bsigma", "sqrt")


def regularize_gram(H: Tensor, lambda_frac: float = 0.01) -> Tensor:
    m = H.shape[-1]
    lam = lambda_frac * linalg.trace(H) / m
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    return H + (lam + 1e-8)[..., None, None] * eye


def gram_root(H: Tensor, eps: float = 1e-10):
    """Non-symmetric root R = S^{1/2} U^T with H = R^T R, plus its inverse,
    for each matrix of ``(..., m, m)``.  Eigenvalues are floored at ``eps *
    max_eig`` (pseudo-inverse path for a rank-deficient H)."""
    H = H.float()
    evals, evecs = linalg.eigh(H)
    floor = eps * evals[..., -1:].clamp_min(1e-30)
    sq = torch.sqrt(torch.maximum(evals, floor))
    R = sq[..., :, None] * evecs.mT
    Rinv = evecs * (1.0 / sq)[..., None, :]
    return R, Rinv


def split_factors(RinvU: Tensor, S: Tensor, V: Tensor, split: str):
    if split == "paper":
        return RinvU * S[..., None, :], V
    if split == "bsigma":
        return RinvU, V * S[..., None, :]
    if split == "sqrt":
        rt = torch.sqrt(S)
        return RinvU * rt[..., None, :], V * rt[..., None, :]
    raise ValueError(f"unknown split {split!r}; options {SPLITS}")


def cloq_init(H: Tensor, dW: Tensor, rank: int, split: str = "paper"):
    """Closed-form (A (m,r), B (n,r)) minimizing ||X (A B^T - dW)||_F^2,
    or one pair per matrix of a bucket's stack ``(L, m, n)``.  ``H`` must
    already be regularized (Algorithm 1 input)."""
    dW = dW.float()
    R, Rinv = gram_root(H)
    U, S, Vh = linalg.svd(R @ dW)
    del R
    r = rank
    return split_factors(Rinv @ U[..., :r], S[..., :r], Vh[..., :r, :].mT,
                         split)


def cloq_site_lora(Hs, dW: Tensor, rank: int, split: str = "paper",
                   mesh=None, axis: str = "model",
                   lambda_frac: float = 0.01):
    """Per-site CLoQ adapters of a weight-shared block: one Theorem-3.1
    solve a call site against the site's own Gram, with the residual
    ``dW = W - Q`` of the (pooled-Gram) shared base fixed.

    ``Hs`` holds the sites' *unregularized* Grams, stacked ``(S, m, m)``
    or as a sequence of ``(m, m)`` (no stacked copy: Zamba2-7B's 13 sites
    of ``mlp.down`` are 10.7 GB of f32); ``dW`` is (m, n).  Returns
    ``(As (S, m, r), Bs (S, n, r))`` with ``r = min(rank, n)``, as
    ``cloq_init`` cuts a rank above ``n``.

    With ``mesh`` every rank solves on its own columns of ``dW`` through
    :func:`cloq_lowrank_local` (the caller makes sure ``n`` divides the
    axis: the planner's gate, ``batched.bucket_shards``): ``As`` comes back
    replicated and ``Bs`` column-sharded over ``axis``, both as DTensors.
    The sites are solved one at a time, one ``(m, m)`` all-reduce each (the
    JAX twin fuses them into one ``(S, m, m)`` collective), so that one
    site's Gram root is held at a time."""
    dW = dW.float()
    if mesh is None:
        outs = [cloq_init(regularize_gram(H.float(), lambda_frac), dW, rank,
                          split) for H in Hs]
        return (torch.stack([a for a, _ in outs]),
                torch.stack([b for _, b in outs]))
    group = parallel.axis_group(mesh, axis)
    dW_l = parallel.local_slice(dW, (None, axis), mesh)
    outs = []
    for H in Hs:
        R, Rinv = gram_root(regularize_gram(H.float(), lambda_frac))
        outs.append(cloq_lowrank_local(R, Rinv, dW_l, rank, split, group))
        del R, Rinv
    As = torch.stack([a for a, _ in outs])
    Bs = torch.stack([b for _, b in outs])
    return (parallel.distribute_local(As, (None, None, None), mesh),
            parallel.distribute_local(Bs, (None, axis, None), mesh))


def cloq_lowrank_local(R: Tensor, Rinv: Tensor, dW_local: Tensor, rank: int,
                       split: str = "paper", group=None):
    """Shard-local body of the Gram-trick CLoQ solve: the exact top-``rank``
    factorization of ``R^{-1} LR_r(R dW)`` from a column shard
    ``dW_local (..., m, n_local)`` of the residual,

        G = (R dW)(R dW)^T        -- all-reduced over ``group`` when given
        eigh(G) -> U, S^2         -- the same on every rank
        V_local = (R dW)_l^T U S^{-1}   -- shard-local

    ``R``, ``Rinv``: the non-symmetric root of the *regularized* Gram and
    its inverse (:func:`gram_root`), the same on every rank.  ``group=None``
    means ``dW_local`` holds all columns.  Returns ``(A (..., m, r), B_local
    (..., n_local, r))``.  Uses ``eigh`` of the ``m x m`` Gram instead of
    the unsharded path's ``svd(R dW)``: the same subspace to float precision
    (compare the ``A B^T`` product).  The Gram-trick core is LoftQ's
    (:func:`repro_torch.core.loftq.svd_lowrank_topr`) with ``R != I``."""
    from repro_torch.core.loftq import svd_lowrank_topr
    M_l = R @ dW_local.float()                          # (..., m, n_local)
    U, S, V_l = svd_lowrank_topr(M_l, rank, group)
    return split_factors(Rinv @ U, S, V_l, split)


def cloq_init_sharded(H: Tensor, dW: Tensor, rank: int, mesh,
                      axis: str = "model", split: str = "paper"):
    """Distributed CLoQ: every rank solves on its columns of ``dW (m, n)``
    (``n`` divisible by the axis) with ``H`` already regularized.
    Communication: one ``m x m`` f32 all-reduce.  Returns ``(A (m, r)``
    replicated, ``B (n, r)`` row-sharded over ``axis``) as DTensors."""
    R, Rinv = gram_root(H.float())
    dW_l = parallel.local_slice(dW.float(), (None, axis), mesh)
    A, B_l = cloq_lowrank_local(R, Rinv, dW_l, rank, split,
                                parallel.axis_group(mesh, axis))
    return (parallel.distribute_local(A, (None, None), mesh),
            parallel.distribute_local(B_l, (axis, None), mesh))


def lowrank_objective(H: Tensor, dW: Tensor, A: Tensor, B: Tensor) -> float:
    """||X (A B^T - dW)||_F given H = X^T X."""
    D = A @ B.T - dW
    v = torch.einsum("ij,ik,kj->", D, H, D)
    return float(torch.sqrt(v.clamp_min(0.0)))


def discrepancy_norms(H: Tensor, Q: Tensor, A: Tensor, B: Tensor, W: Tensor):
    """Paper Fig. 2 quantities: ||X(Q + AB^T - W)|| in Frobenius and spectral
    norm (spectral computed on R D, since ||XD||_2 = ||R D||_2)."""
    D = Q + A @ B.T - W
    R, _ = gram_root(H)
    RD = R @ D
    return (float(torch.linalg.norm(RD)),
            float(torch.linalg.matrix_norm(RD, ord=2)))
