"""LoftQ, QLoRA and GPTQ-LoRA baselines: the paper's comparisons.

PyTorch twin of the single-device functions of ``repro.core.loftq``.

LoftQ (Li et al., 2023) is a data-free alternating Q/low-rank init:

    min_{Q, A, B}  || Q + A B^T - W ||_F^2                    (paper eq. 6)

AltMin: Q <- quant(W - A B^T);  (A, B) <- SVD_r(W - Q), split as
A = U_r S_r^{1/2}, B = V_r S_r^{1/2} (LoftQ's choice), 5 rounds by default,
on the uniform INT grid or NF4.  QLoRA and GPTQ-LoRA keep their base (NF4
round-to-nearest; the OPTQ sweep) and start the adapters at zero
perturbation: ``A ~ N(0, 1/m)``, ``B = 0``.  ``A`` is drawn with the
caller's ``torch.Generator``; it cannot match ``jax.random`` bit for bit.

Every function also takes a bucket's stack ``(L, m, n)``.

Distributed: the RTN round trip inside each AltMin round is per output
column, and the rank-r SVD of the full-width residual ``W - Q`` is
recovered exactly from a column shard through the Gram trick
(:func:`svd_lowrank_topr`: ``G = (W-Q)(W-Q)^T`` all-reduced over the
mesh axis's group, ``eigh`` replicated, ``V`` shard-local), so
:func:`loftq_init` runs column-sharded with one ``(L, m, m)`` all-reduce
an AltMin round.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import linalg
from repro_torch.models.parallel import all_reduce_sum
from repro_torch.core.quantizer import (QuantConfig, dequantize_int,
                                        dequantize_nf4, quantize_int,
                                        quantize_nf4)

Tensor = torch.Tensor


def _rtn_roundtrip(W: Tensor, cfg: QuantConfig):
    if cfg.fmt == "nf4":
        codes, absmax = quantize_nf4(W, cfg.group_size)
        return dequantize_nf4(codes, absmax, cfg.group_size), (codes, absmax)
    codes, s, z = quantize_int(W, cfg.bits, cfg.group_size)
    return dequantize_int(codes, s, z, cfg.group_size), (codes, s, z)


def svd_lowrank_topr(dW_local: Tensor, rank: int, group=None):
    """Top-``rank`` SVD factors of the full-width ``dW`` from a column
    shard ``(..., m, n_local)``:

        G = dW dW^T          -- all-reduced over ``group`` when given
        eigh(G) -> U, S^2    -- the same on every rank
        V_local = dW_l^T U S^{-1}   -- shard-local

    Returns ``(U (..., m, r), S (..., r), V_local (..., n_local, r))``; a
    stack's Grams go out in one all-reduce.  The eigenvalues of the Gram
    are the squared singular values, so the factors' condition is the
    square of the unsharded path's ``svd``: the same subspace to float
    precision (the tests compare ``A B^T``)."""
    G = dW_local @ dW_local.mT
    G = all_reduce_sum(G.contiguous(), group)
    evals, evecs = linalg.eigh(G)                       # ascending
    top = evals.flip(-1)[..., :rank]
    U = evecs.flip(-1)[..., :rank]
    S = torch.sqrt(top.clamp_min(1e-30))
    V_l = (dW_local.mT @ U) / S[..., None, :]           # (..., n_local, r)
    return U, S, V_l


def loftq_init(W: Tensor, cfg: QuantConfig, rank: int, iters: int = 5,
               group=None, gram_trick: bool | None = None):
    """Returns (Q_dequant, A, B, qstate) after ``iters`` AltMin rounds, each
    a full thin SVD of ``W - Q``.  With ``group`` (the mesh axis's process
    group) ``W`` is this rank's column shard: the rank-r factors come from
    :func:`svd_lowrank_topr`, one all-reduce a round; ``A`` comes back the
    same on every rank, ``B`` and ``qstate`` cover the local columns.
    ``gram_trick`` (default: whether there is a group) takes the factors
    through :func:`svd_lowrank_topr` without a group too: the sharded
    factorization on all columns, what a sharded run is held against (the
    AltMin rounds carry the ``eigh``/``svd`` difference of one solve into
    the next rounding, so the two factorizations drift apart at full
    width)."""
    W = W.float()
    m, n = W.shape[-2:]
    A = W.new_zeros((*W.shape[:-2], m, rank))
    B = W.new_zeros((*W.shape[:-2], n, rank))
    Qd, qstate = _rtn_roundtrip(W, cfg)
    gram_trick = group is not None if gram_trick is None else gram_trick
    for _ in range(iters):
        Qd, qstate = _rtn_roundtrip(W - A @ B.mT, cfg)
        if not gram_trick:
            U_f, S_f, Vh = linalg.svd(W - Qd)
            U, S, V = U_f[..., :rank], S_f[..., :rank], Vh[..., :rank, :].mT
        else:
            U, S, V = svd_lowrank_topr(W - Qd, rank, group)
        rt = torch.sqrt(S)
        A = U * rt[..., None, :]
        B = V * rt[..., None, :]
    return Qd, A, B, qstate


def lora_normal(gen: torch.Generator, m: int, rank: int,
                device: torch.device) -> Tensor:
    """The random half of a zero-perturbation LoRA init: ``A ~ N(0, 1/m)``,
    ``(m, rank)`` f32 drawn from ``gen``."""
    return torch.randn((m, rank), generator=gen, dtype=torch.float32,
                       device=device) / math.sqrt(m)


def qlora_init(W: Tensor, cfg: QuantConfig, A: Tensor):
    """QLoRA baseline: NF4 round-to-nearest base and the adapters ``(A, 0)``
    with ``A`` drawn by the caller (:func:`lora_normal`).  Returns (Q_dequant,
    A, B, (codes, absmax))."""
    W = W.float()
    nf4_cfg = QuantConfig(bits=4, group_size=cfg.group_size, fmt="nf4")
    Qd, qstate = _rtn_roundtrip(W, nf4_cfg)
    B = W.new_zeros((*W.shape[:-2], W.shape[-1], A.shape[-1]))
    return Qd, A, B, qstate


def gptq_lora_init(A: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """GPTQ-LoRA baseline: OPTQ base (computed by the caller) and the
    adapters ``(A, 0)`` with ``A`` drawn by the caller."""
    return A, A.new_zeros((*A.shape[:-2], n, A.shape[-1]))
