"""Uniform INT-b quantizer (asymmetric, group-wise) + NF4, with bit packing.

PyTorch twin of ``repro.core.quantizer``; every function computes the same
values on the same inputs (codes, scales, zeros and packed bytes are
bit-exact against the JAX package).  Each also takes a leading stack of
weights ``(L, m, n)`` (one bucket of the batched engine) and treats every
slice as the 2-D call would.

Conventions
-----------
Weights follow the paper's ``y = X @ W`` layout: ``W`` has shape ``(m, n)``
with ``m`` = in-features (reduction dim) and ``n`` = out-features.
Quantization groups run along the **input** dim (axis 0), matching OPTQ's
sweep order, with ``group_size=64`` default; ``group_size=None`` means
per-(output-)channel, i.e. one group spanning the whole column.

Storage layout of a quantized linear layer:
    qweight : packed codes. int2/int4 pack 4/2 codes per uint8 along axis 0
              -> shape (m*bits/8, n) uint8; 3-bit and 8-bit codes are stored
              unpacked as uint8.
    scales  : (m/g, n) f32   (delta)
    zeros   : (m/g, n) f32   (integer zero-point z, stored as f32)
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# NF4 grid from the QLoRA paper (Dettmers et al., 2023), appendix E.
NF4_LEVELS = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def nf4_levels(device=None) -> Tensor:
    return torch.tensor(NF4_LEVELS, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 4
    group_size: int | None = 64      # None => per-output-channel
    fmt: str = "int"                 # "int" | "nf4"
    act_order: bool = False          # OPTQ activation ordering
    magr: bool = True                # MagR preprocessing before OPTQ
    magr_alpha: float = 1e-3
    magr_iters: int = 20
    lambda_frac: float = 0.01        # damping: lambda = frac * tr(H)/m
    block_size: int = 128            # OPTQ sweep block

    def codes_per_byte(self) -> int:
        return {2: 4, 3: 1, 4: 2, 8: 1}[self.bits]

    @property
    def n_levels(self) -> int:
        return 2 ** self.bits


def stable_round(x: Tensor) -> Tensor:
    """Round-half-up with the decision boundary nudged off exact midpoints:
    ``floor(x + 0.5 + 1e-5)``.  MagR's l-inf prox puts quantization ratios
    exactly on ``k + 0.5``; the nudge makes every program variant round
    those ties identically (see ``repro.core.quantizer.stable_round``)."""
    return torch.floor(x + (0.5 + 1e-5))


def _group_reshape(w: Tensor, group_size: int | None):
    *lead, m, n = w.shape
    g = m if group_size is None else int(group_size)
    if m % g:
        raise ValueError(f"in-features {m} not divisible by group {g}")
    return w.reshape(*lead, m // g, g, n), g


def quant_params(w: Tensor, bits: int, group_size: int | None = 64):
    """Asymmetric min/max scale+zero per group. Returns (scales, zeros)."""
    wg, _ = _group_reshape(w.float(), group_size)
    wmin = wg.amin(dim=-2).clamp_max(0.0)
    wmax = wg.amax(dim=-2).clamp_min(0.0)
    scale = ((wmax - wmin) / (2 ** bits - 1)).clamp_min(1e-9)
    zero = stable_round(-wmin / scale).clamp(0, 2 ** bits - 1)
    return scale, zero


def quantize_int(w: Tensor, bits: int, group_size: int | None = 64,
                 scales: Tensor | None = None, zeros: Tensor | None = None):
    """Round-to-nearest INT quantization. Returns (codes uint8 (m,n), scales, zeros)."""
    w = w.float()
    if scales is None or zeros is None:
        scales, zeros = quant_params(w, bits, group_size)
    wg, _ = _group_reshape(w, group_size)
    q = (stable_round(wg / scales[..., None, :]) + zeros[..., None, :]).clamp(
        0, 2 ** bits - 1)
    return q.reshape(w.shape).to(torch.uint8), scales, zeros


def dequantize_int(codes: Tensor, scales: Tensor, zeros: Tensor,
                   group_size: int | None = 64, dtype=torch.float32) -> Tensor:
    cg, _ = _group_reshape(codes.float(), group_size)
    w = (cg - zeros[..., None, :]) * scales[..., None, :]
    return w.reshape(codes.shape).to(dtype)


# -------------------------- bit packing -----------------------------------


def _pack_factor(bits: int) -> int | None:
    return {2: 4, 4: 2}.get(bits)


def pack_codes(codes: Tensor, bits: int) -> Tensor:
    """Pack uint8 codes (values < 2^bits) along axis 0 into uint8 words:
    consecutive rows share a byte, row ``j`` of a word at shift ``bits*j``.
    3-bit and 8-bit codes pass through unpacked."""
    codes = codes.to(torch.uint8)
    per = _pack_factor(bits)
    if per is None:
        return codes
    *lead, m, n = codes.shape
    if m % per:
        raise ValueError(f"rows {m} not divisible by pack factor {per}")
    c = codes.reshape(*lead, m // per, per, n)
    word = torch.zeros((*lead, m // per, n), dtype=torch.uint8,
                       device=codes.device)
    for j in range(per):
        word = word | (c[..., j, :] << (bits * j))
    return word


def unpack_codes(packed: Tensor, bits: int, m: int) -> Tensor:
    per = _pack_factor(bits)
    if per is None:
        return packed
    mask = 2 ** bits - 1
    parts = [(packed >> (bits * j)) & mask for j in range(per)]
    return torch.stack(parts, dim=-2).reshape(*packed.shape[:-2], m,
                                              packed.shape[-1])


# ----------------------------- NF4 -----------------------------------------


def quantize_nf4(w: Tensor, group_size: int | None = 64):
    """NF4 (QLoRA): absmax-normalized nearest-level codes per group.

    Returns (codes uint8 (m,n) in [0,16), absmax (m/g, n)).  The nearest
    level is the first of the closest (``argmin``'s tie rule), found level
    by level so that a bucket's stack needs no 16-wide distance tensor."""
    w = w.float()
    wg, _ = _group_reshape(w, group_size)
    absmax = wg.abs().amax(dim=-2).clamp_min(1e-9)
    norm = wg / absmax[..., None, :]
    levels = nf4_levels(w.device)
    best = (norm - levels[0]).abs()
    codes = torch.zeros(norm.shape, dtype=torch.uint8, device=w.device)
    for i in range(1, len(NF4_LEVELS)):
        d = (norm - levels[i]).abs()
        closer = d < best
        best = torch.where(closer, d, best)
        codes.masked_fill_(closer, i)
    return codes.reshape(w.shape), absmax


def dequantize_nf4(codes: Tensor, absmax: Tensor,
                   group_size: int | None = 64, dtype=torch.float32) -> Tensor:
    cg, _ = _group_reshape(codes.long(), group_size)
    w = nf4_levels(codes.device)[cg] * absmax[..., None, :]
    return w.reshape(codes.shape).to(dtype)


def rtn(w: Tensor, cfg: QuantConfig) -> Tensor:
    """Round-to-nearest dequantized weights (data-free baseline)."""
    if cfg.fmt == "nf4":
        codes, absmax = quantize_nf4(w, cfg.group_size)
        return dequantize_nf4(codes, absmax, cfg.group_size)
    codes, s, z = quantize_int(w, cfg.bits, cfg.group_size)
    return dequantize_int(codes, s, z, cfg.group_size)


def quant_state_size_bytes(m: int, n: int, cfg: QuantConfig) -> int:
    """Storage cost of the quantized layer (codes + scales + zeros)."""
    g = m if cfg.group_size is None else cfg.group_size
    code_bytes = m * n if cfg.bits in (3, 8) else m * n * cfg.bits // 8
    meta = (m // g) * n * 4 * 2
    return code_bytes + meta
