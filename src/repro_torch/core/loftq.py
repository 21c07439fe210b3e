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

Every function also takes a bucket's stack ``(L, m, n)``; the column-
sharded variant (``svd_lowrank_topr``) waits for the distributed port.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import linalg
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


def loftq_init(W: Tensor, cfg: QuantConfig, rank: int, iters: int = 5):
    """Returns (Q_dequant, A, B, qstate) after ``iters`` AltMin rounds, each
    a full thin SVD of ``W - Q``."""
    W = W.float()
    m, n = W.shape[-2:]
    A = W.new_zeros((*W.shape[:-2], m, rank))
    B = W.new_zeros((*W.shape[:-2], n, rank))
    Qd, qstate = _rtn_roundtrip(W, cfg)
    for _ in range(iters):
        Qd, qstate = _rtn_roundtrip(W - A @ B.mT, cfg)
        U_f, S_f, Vh = linalg.svd(W - Qd)
        U, S, V = U_f[..., :rank], S_f[..., :rank], Vh[..., :rank, :].mT
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
