"""Plain PyTorch versions of every ported kernel.

Each computes its kernel's whole function on any device: the CPU tests run
them, the ``ops`` wrappers take them for CPU tensors, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantizer import dequantize_int, unpack_codes

Tensor = torch.Tensor

NEG_INF = -1e30


def dequant_matmul_ref(x: Tensor, packed: Tensor, scales: Tensor,
                       zeros: Tensor, *, bits: int,
                       group_size: int | None) -> Tensor:
    """y = x @ ((codes - z) * s).  x (..., K); packed (K*bits/8, N).  x and
    the dequantized weight are upcast to f32, accumulated in f32, and the
    result is cast back to x.dtype."""
    K = x.shape[-1]
    codes = unpack_codes(packed, bits, K)
    w = dequantize_int(codes, scales, zeros, group_size, dtype=torch.float32)
    return (x.float() @ w).to(x.dtype)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True,
                        lengths: Tensor | None = None) -> Tensor:
    """q (B, Hq, Sq, d); k/v (B, Hkv, Sk, d) -> (B, Hq, Sq, d) in q.dtype.

    GQA by head grouping (query head h reads KV head ``h // (Hq/Hkv)``),
    softmax in f32.  ``causal`` masks keys at ``kpos > qpos`` with query 0
    aligned to key 0; ``lengths`` (B,) masks keys at ``kpos >= lengths[b]``
    (every length must be >= 1)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kk = k.repeat_interleave(rep, dim=1).float()
    vv = v.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])[None, None]
    if lengths is not None:
        valid = kpos[None, :] < lengths.to(q.device)[:, None]      # (B, Sk)
        mask = mask & valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)
