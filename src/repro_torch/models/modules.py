"""Minimal functional module system: init functions return nested dicts of
tensors, apply functions consume them.  PyTorch twin of
``repro.models.modules``.

Linear layers are the quantization surface: ``linear_apply`` handles dense
weights, packed-quantized weights (OPTQ/CLoQ state, or NF4), LoRA adapters
(one shared pair, or one pair per request), and records calibration
activations inside a ``capture_grams`` context.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantizer import (dequantize_int, dequantize_nf4,
                                        unpack_codes)
from repro_torch.utils import current_scope, record_activation

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QSpec:
    """Static quantization spec threaded through model configs."""
    bits: int = 4
    group_size: int = 64
    rank: int = 64
    method: str = "cloq"          # cloq | loftq | rtn | gptq | qlora(nf4)
    split: str = "paper"
    use_kernel: bool = False      # CUDA dequant-matmul + flash-decode kernels


def _randn(gen: torch.Generator, shape, device) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def linear_init(gen: torch.Generator, m: int, n: int, *,
                dtype=torch.bfloat16, bias: bool = False, lora_rank: int = 0,
                scale: float | None = None, device=None) -> dict:
    scale = 1.0 / math.sqrt(m) if scale is None else scale
    p = {"w": (_randn(gen, (m, n), device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    if lora_rank:
        p["lora_a"] = (_randn(gen, (m, lora_rank), device)
                       / math.sqrt(m)).to(dtype)
        p["lora_b"] = torch.zeros((n, lora_rank), dtype=dtype, device=device)
    return p


def packed_bits(mp: int, m: int) -> int:
    """Bit-width of a packed ``qcodes`` leaf from its row count (``m``
    in-features packed to ``mp`` uint8 rows); unpacked storage (3- and
    8-bit) is returned as 8."""
    if mp * 4 == m:
        return 2
    if mp * 2 == m:
        return 4
    if mp != m:
        raise ValueError(f"qcodes rows {mp} do not match in-features {m}")
    return 8


def _group_of(meta: Tensor, m: int) -> int:
    """Group size recovered from a (m/g, n) scales/absmax leaf."""
    return m // meta.shape[-2]


def linear_apply(p: dict, x: Tensor, qspec: QSpec | None = None) -> Tensor:
    """y = x @ W (+ LoRA path + bias).  W may be dense or packed-quantized;
    each quantized site dequantizes from its own stored shapes, and
    ``qspec.use_kernel`` only gates the kernel path.  On the kernel path a
    packed-INT site with 2-D LoRA and at least ``FUSED_LORA_MIN_ROWS`` rows
    of x (fine-tuning, not decode) runs the base and the LoRA term in one
    fused kernel (same math as the unfused path)."""
    record_activation(current_scope(), x)
    m = x.shape[-1]
    fused = False
    if "qcodes" in p:
        if qspec is None:
            raise ValueError("quantized params need a QSpec")
        if "absmax" in p:                      # NF4 (QLoRA baseline)
            codes = unpack_codes(p["qcodes"], 4, m)
            w = dequantize_nf4(codes, p["absmax"], _group_of(p["absmax"], m),
                               x.dtype)
            y = x @ w
        else:
            bits = packed_bits(p["qcodes"].shape[-2], m)
            group = _group_of(p["scales"], m)
            if qspec.use_kernel:
                from repro_torch.kernels import ops as kops
                fused = ("lora_a" in p and p["lora_a"].dim() == 2 and
                         x.numel() // m >= kops.FUSED_LORA_MIN_ROWS)
            if fused:
                y = kops.dequant_matmul_lora(
                    x, p["qcodes"], p["scales"], p["zeros"],
                    p["lora_a"].to(x.dtype), p["lora_b"].to(x.dtype),
                    bits=bits, group_size=group)
            elif qspec.use_kernel:
                y = kops.dequant_matmul(x, p["qcodes"], p["scales"],
                                        p["zeros"], bits=bits,
                                        group_size=group)
            else:
                codes = unpack_codes(p["qcodes"], bits, m)
                w = dequantize_int(codes, p["scales"], p["zeros"], group,
                                   dtype=x.dtype)
                y = x @ w
    else:
        y = x @ p["w"].to(x.dtype)
    if "lora_a" in p and not fused:
        a = p["lora_a"].to(x.dtype)
        b = p["lora_b"].to(x.dtype)
        if a.dim() == 3:
            # per-request adapters: a (B, m, r), b (B, n, r)
            y = y + torch.einsum("bsr,bnr->bsn",
                                 torch.einsum("bsm,bmr->bsr", x, a), b)
        else:
            y = y + (x @ a) @ b.T
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {"w": (_randn(gen, (vocab, d), device) * 0.02).to(dtype)}


def embedding_apply(p: dict, tokens: Tensor) -> Tensor:
    return torch.nn.functional.embedding(tokens.long(), p["w"])


def lm_head_apply(p: dict, x: Tensor) -> Tensor:
    """Logits. ``p`` may be a tied embedding ({'w': (V, d)}) or a linear."""
    w = p["w"].to(x.dtype)
    if w.shape[0] != x.shape[-1]:          # tied embedding (V, d)
        return x @ w.T
    return x @ w
