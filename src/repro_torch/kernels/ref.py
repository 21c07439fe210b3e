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


def dequant_matmul_lora_ref(x: Tensor, packed: Tensor, scales: Tensor,
                            zeros: Tensor, lora_a: Tensor, lora_b: Tensor, *,
                            bits: int, group_size: int | None) -> Tensor:
    """y = x @ Wq + (x @ A) @ B^T.  lora_a (K, r), lora_b (N, r).  The base
    product and the LoRA term are each taken in f32 and added in f32; the
    sum is cast to x.dtype.  Differentiable by autograd in x, A and B."""
    base = dequant_matmul_ref(x, packed, scales, zeros, bits=bits,
                              group_size=group_size).float()
    xa = x.float() @ lora_a.float()
    return (base + xa @ lora_b.float().T).to(x.dtype)


def gram_ref(x: Tensor) -> Tensor:
    """H = X^T X in f32.  x (T, D) of any float type, upcast first."""
    x32 = x.float()
    return x32.T @ x32


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True,
                        lengths: Tensor | None = None,
                        return_lse: bool = False):
    """q (B, Hq, Sq, d); k/v (B, Hkv, Sk, d) -> (B, Hq, Sq, d) in q.dtype.

    GQA by head grouping (query head h reads KV head ``h // (Hq/Hkv)``),
    softmax in f32.  ``causal`` masks keys at ``kpos > qpos`` with query 0
    aligned to key 0; ``lengths`` (B,) masks keys at ``kpos >= lengths[b]``
    (every length must be >= 1).

    ``return_lse`` (the partial mode): returns ``(out, lse)``, ``out`` in
    f32 and ``lse`` (B, Hq, Sq) f32 the log-sum-exp of each row's valid
    scaled logits ``q.k / sqrt(d)``; a length may be 0, and a row with no
    valid key gives ``out`` 0 and ``lse`` -inf."""
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
    if return_lse:
        masked = torch.where(mask, logits, -math.inf)
        lse = torch.logsumexp(masked, dim=-1)                  # (B,Hq,Sq)
        live = torch.isfinite(lse)
        shift = torch.where(live, lse, 0.0)[..., None]
        probs = torch.where(mask & live[..., None],
                            torch.exp(masked - shift), 0.0)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vv), lse
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)
