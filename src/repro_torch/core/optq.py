"""OPTQ/GPTQ layer-wise post-training quantization in PyTorch.

PyTorch twin of the single-device functions of ``repro.core.optq``.
Solves ``min_{Q in grid} ||X (Q - W)||_F^2`` with the blocked Cholesky
error-compensation sweep of Frantar et al. (2022) in the ``y = X @ W``
convention: ``W`` is ``(m, n)``, the sweep runs over the input dim ``m``
(rows), and all ``n`` output columns are compensated jointly.  Static
per-group grids are computed up front from the (MagR-preprocessed)
weights.  The row sweep is plain eager PyTorch, a few small launches per
row; on a bucket's stack ``(L, m, n)`` each of those launches covers the
row of all ``L`` matrices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import linalg
from repro_torch.core.quantizer import QuantConfig, quant_params, stable_round

Tensor = torch.Tensor


def dampen(H: Tensor, lambda_frac: float) -> Tensor:
    m = H.shape[-1]
    lam = lambda_frac * linalg.trace(H) / m
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    return H + (lam + 1e-8)[..., None, None] * eye


def inv_cholesky_upper(H: Tensor) -> Tensor:
    """Upper-triangular U with H^{-1} = U^T @ U (the factor GPTQ's sweep
    consumes row by row), for each slice of ``(..., m, m)``; NaN for a
    slice whose damped Gram is not positive definite (as in JAX)."""
    m = H.shape[-1]
    L = linalg.cholesky(H)
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    del L
    Hinv = Linv.mT @ Linv
    del Linv
    return linalg.cholesky(Hinv).mT


def _optq_core(W: Tensor, H: Tensor, srow: Tensor, zrow: Tensor, *,
               bits: int, block_size: int, act_order: bool):
    """Blocked GPTQ sweep over ``W (..., m, n)`` with Grams ``H (..., m,
    m)``; ``srow``/``zrow`` are per-row (..., m, n) grids.  Requires ``m %
    block_size == 0``.  Each row's ops act on the ``(..., n)`` slice of
    every matrix of the stack at once; the lazy tail update is one
    (batched) product a block.  Returns (Qd f32, Qc uint8)."""
    m, n = W.shape[-2:]
    lead = W.shape[:-2]
    bs = block_size
    if act_order:
        perm = torch.argsort(-torch.diagonal(H, dim1=-2, dim2=-1), dim=-1,
                             stable=True)
        inv_perm = torch.argsort(perm, dim=-1, stable=True)
        rows = perm[..., None]
        W = torch.take_along_dim(W, rows, dim=-2)
        H = torch.take_along_dim(torch.take_along_dim(H, rows, dim=-2),
                                 perm[..., None, :], dim=-1)
        srow = torch.take_along_dim(srow, rows, dim=-2)
        zrow = torch.take_along_dim(zrow, rows, dim=-2)

    U = inv_cholesky_upper(H)
    dU = torch.diagonal(U, dim1=-2, dim2=-1)
    maxq = 2.0 ** bits - 1.0
    Wc = W.clone()
    Qd = torch.empty_like(W)
    Qc = torch.empty((*lead, m, n), dtype=torch.uint8, device=W.device)
    for start in range(0, m, bs):
        stop = start + bs
        Wb = Wc[..., start:stop, :].clone()
        Ubb = U[..., start:stop, start:stop]
        Err = torch.empty((*lead, bs, n), dtype=W.dtype, device=W.device)
        for i in range(bs):
            r = start + i
            s_i, z_i = srow[..., r, :], zrow[..., r, :]
            q = (stable_round(Wb[..., i, :] / s_i) + z_i).clamp(0.0, maxq)
            dq = (q - z_i) * s_i
            err = (Wb[..., i, :] - dq) / dU[..., r, None]
            Wb[..., i + 1:, :] -= Ubb[..., i, i + 1:, None] * err[..., None, :]
            Qd[..., r, :] = dq
            Qc[..., r, :] = q.to(torch.uint8)
            Err[..., i, :] = err
        # lazy tail update for rows >= stop
        if stop < m:
            Wc[..., stop:, :] -= U[..., start:stop, stop:].mT @ Err
    if act_order:
        back = inv_perm[..., None]
        Qd = torch.take_along_dim(Qd, back, dim=-2)
        Qc = torch.take_along_dim(Qc, back, dim=-2)
    return Qd, Qc


def _per_row_grids(scales: Tensor, zeros: Tensor, m: int,
                   group_size: int | None):
    g = m if group_size is None else int(group_size)
    return (scales.repeat_interleave(g, dim=-2),
            zeros.repeat_interleave(g, dim=-2))


def pick_block(m: int, block_size: int) -> int:
    """Largest divisor of ``m`` that is <= ``block_size`` (sweep block)."""
    if m % block_size == 0:
        return block_size
    for b in range(min(block_size, m), 0, -1):
        if m % b == 0:
            return b
    return m


def optq_quantize_core(W: Tensor, H: Tensor, cfg: QuantConfig,
                       scales: Tensor | None = None,
                       zeros: Tensor | None = None):
    """OPTQ sweep with ``cfg.block_size`` already a divisor of ``m``
    (resolve it with :func:`pick_block` at plan time).  ``W`` is ``(m, n)``
    or a bucket's stack ``(L, m, n)`` with Grams ``(L, m, m)``.  ``H`` is
    the *undamped* Gram; damping is applied here.  Returns (Q_dequant f32,
    codes uint8, scales, zeros)."""
    W = W.float()
    H = dampen(H.float(), cfg.lambda_frac)
    if scales is None or zeros is None:
        scales, zeros = quant_params(W, cfg.bits, cfg.group_size)
    srow, zrow = _per_row_grids(scales, zeros, W.shape[-2], cfg.group_size)
    Qd, Qc = _optq_core(W, H, srow, zrow, bits=cfg.bits,
                        block_size=cfg.block_size, act_order=cfg.act_order)
    return Qd, Qc, scales, zeros


def optq_quantize(W: Tensor, H: Tensor, cfg: QuantConfig,
                  scales: Tensor | None = None, zeros: Tensor | None = None):
    """OPTQ sweep.  Returns (Q_dequant (m,n) f32, codes uint8, scales, zeros).

    ``H`` is the *undamped* Gram; damping is applied here.  Grids are
    static per group, computed from ``W`` unless provided."""
    bs = pick_block(W.shape[-2], cfg.block_size)
    if bs != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=bs)
    return optq_quantize_core(W, H, cfg, scales, zeros)


def optq_quantize_sharded(W: Tensor, H: Tensor, cfg: QuantConfig, mesh,
                          axis: str = "model"):
    """Distributed OPTQ: output columns sharded over ``axis``.  ``H`` is the
    same on every rank and the sweep needs no communication (columns are
    independent given ``H``): each rank runs :func:`optq_quantize_core` on
    its own columns of ``W`` (``n`` divisible by the axis), with the sweep
    block resolved here.  Returns ``(Qd (m, n), codes uint8, scales (m/g,
    n), zeros (m/g, n))``, each a DTensor column-sharded over ``axis``."""
    from repro_torch.models import parallel
    bs = pick_block(W.shape[-2], cfg.block_size)
    if bs != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=bs)
    col = (None, axis)
    outs = optq_quantize_core(parallel.local_slice(W.float(), col, mesh),
                              H.float(), cfg)
    return tuple(parallel.distribute_local(o.contiguous(), col, mesh)
                 for o in outs)


def cholesky_factor_finite(H: Tensor, lambda_frac: float = 0.01) -> bool:
    """Does the *damped* Gram admit a finite Cholesky factor?  The check the
    health guards use to name the classic OPTQ failure (a finite but
    effectively non-PSD Gram whose factor is NaN)."""
    U = inv_cholesky_upper(dampen(H.float(), lambda_frac))
    return bool(torch.isfinite(U).all())


def gram_error(H: Tensor, D: Tensor) -> float:
    """sqrt(Tr(D^T H D)) = ||X D||_F given H = X^T X."""
    v = torch.einsum("ij,ik,kj->", D, H, D)
    return float(torch.sqrt(v.clamp_min(0.0)))
