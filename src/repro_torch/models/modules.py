"""Minimal functional module system: init functions return nested dicts of
tensors, apply functions consume them.  PyTorch twin of
``repro.models.modules``.

Linear layers are the quantization surface: ``linear_apply`` handles dense
weights, packed-quantized weights (OPTQ/CLoQ state, or NF4), LoRA adapters
(one shared pair, or one pair per request), and records calibration
activations inside a ``capture_grams`` context.

Under a mesh the leaves are local shards tagged with their layouts
(``models.parallel.localize``).  A linear's collectives are read from the
tags, never from its name: column-sharded (the output dim over "model")
takes its full input through ``parallel.copy_to`` and returns the rank's
output columns; row-sharded (the input dim) takes the rank's input columns
and all-reduces its partial sums (``parallel.finish_row``); the LoRA factor
that stays whole beside a sharded base (``lora_a`` of a column linear,
``lora_b`` of a row one) has its gradient summed over the model axis.  The
embedding and the head are vocab-parallel when their vocab dim is sharded:
a masked local lookup and an all-reduce, and the rank's vocab columns of
the logits, which :func:`vocab_parallel_ll` reduces.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantizer import (dequantize_int, dequantize_nf4,
                                        unpack_codes)
from repro_torch.models import parallel
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
    fused kernel (same math as the unfused path).  Leaves sharded over a
    mesh take :func:`_linear_sharded`."""
    record_activation(current_scope(), x)
    lay = _sharded_layout(p)
    if lay is not None:
        return _linear_sharded(p, x, qspec, lay)
    return _linear_local(p, x, qspec)


# the leaves of a linear and, for each orientation, the dim of each that
# carries the sharded features (the output N for "col", the input K for
# "row"); a leaf not listed is not sharded with them
_BASE = ("w", "qcodes", "scales", "zeros", "absmax")
_SHARD_DIM = {"col": {**{k: -1 for k in _BASE}, "lora_b": -2, "b": -1},
              "row": {**{k: -2 for k in _BASE}, "lora_a": -2}}


def _sharded_layout(p: dict):
    """The layout of a linear's first leaf sharded over "model" (None
    without one)."""
    for k in ("qcodes", "w", "lora_a", "lora_b"):
        t = p.get(k)
        if t is not None and parallel.model_sharded(t):
            return parallel.layout_of(t)
    return None


def _orient(p: dict) -> str:
    """"col" or "row": read from which dim of which leaf is sharded."""
    for k, t in p.items():
        lay = parallel.layout_of(t)
        d = None if lay is None else lay.dim_of("model")
        if d is None:
            continue
        d -= t.dim()
        for orient, dims in _SHARD_DIM.items():
            if dims.get(k) == d:
                return orient
    raise ValueError(f"a linear sharded on no dim it can be: "
                     f"{ {k: parallel.layout_of(t) for k, t in p.items()} }")


def _local_leaf(t: Tensor, dim: int, group) -> Tensor | None:
    """The rank's block of leaf ``t`` along ``dim``: its shard if sharded
    there, else its equal slice (None when ``dim`` does not divide)."""
    lay = parallel.layout_of(t)
    if lay is not None and lay.dim_of("model") is not None:
        return t if lay.dim_of("model") - t.dim() == dim else None
    n = parallel.group_size(group)
    if t.shape[dim] % n:
        return None
    r = torch.distributed.get_rank(group)
    step = t.shape[dim] // n
    return t.narrow(dim, r * step, step)


def _whole_leaf(t: Tensor, group) -> Tensor:
    """Leaf ``t`` whole: gathered along its sharded dim (the gradient
    sliced: every rank then computes the same)."""
    lay = parallel.layout_of(t)
    d = None if lay is None else lay.dim_of("model")
    if d is None:
        return t
    return parallel.gather_from(t, group, d, reduce_grad=False)


def _full_in(p: dict) -> int | None:
    """A linear's full input features, from ``w`` or ``lora_a``."""
    for k in ("w", "lora_a"):
        t = p.get(k)
        if t is not None:
            lay = parallel.layout_of(t)
            return (lay.shape if lay is not None else t.shape)[-2]
    return None


def _linear_sharded(p: dict, x: Tensor, qspec: QSpec | None,
                    lay) -> Tensor:
    """A linear with leaves sharded over "model" (module docstring).  When
    some leaf's sharded dim does not divide the axis, the linear runs
    whole on every rank, as GSPMD would gather it: its sharded leaves
    all-gathered."""
    group = parallel.axis_group(lay.mesh, "model")
    n = parallel.group_size(group)
    orient = _orient(p)
    dims = _SHARD_DIM[orient]
    K = _full_in(p)
    local = {k: (_local_leaf(t, dims[k], group) if k in dims else t)
             for k, t in p.items()}
    if any(v is None for v in local.values()):
        whole = {k: _whole_leaf(t, group) for k, t in p.items()}
        if K is not None and x.shape[-1] * n == K:   # a shard of the input
            x = parallel.gather_from(x, group, -1, reduce_grad=False)
        return _linear_local(whole, x, qspec)
    # the factor left whole beside the sharded base: summed gradients
    other = "lora_a" if orient == "col" else "lora_b"
    if other in local and local[other].dim() == 2:
        local[other] = parallel.copy_to(local[other], group)
    if orient == "col":
        if K is not None and x.shape[-1] != K:
            raise ValueError(f"a column-sharded linear takes its full input "
                             f"({K} features), got {x.shape[-1]}")
        return _linear_local(local, parallel.copy_to(x, group), qspec)
    if K is None:
        raise ValueError("a row-sharded linear needs w or lora_a to tell "
                         "its input features")
    if x.shape[-1] == K:                     # a replicated input: its slice
        x = parallel.scatter_to(x, group, -1)
    elif x.shape[-1] * n != K:
        raise ValueError(f"a row-sharded linear of {K} input features over "
                         f"{n} ranks got {x.shape[-1]}")
    bias = local.pop("b", None)
    y = parallel.finish_row(_linear_local(local, x, qspec), group)
    if bias is not None:
        if parallel.row_scatter_dim() is not None:
            bias = parallel.copy_to(bias, group)   # added on a slice
        y = y + bias.to(y.dtype)
    return y


def _linear_local(p: dict, x: Tensor, qspec: QSpec | None) -> Tensor:
    """:func:`linear_apply` on plain (or local) leaves."""
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


def rmsnorm_apply(p: dict, x: Tensor, eps: float = 1e-6, *, group=None,
                  c0: int = 0, width: int | None = None) -> Tensor:
    """RMSNorm over ``x``'s last dim.  With ``group``, ``x`` holds the
    channels ``c0 ..`` of a norm over ``width`` channels split over that
    group (Mamba's gated norm on the rank's heads): the sum of squares is
    summed over the group (every rank's total used on its own channels, so
    its gradient is summed too) and the rank's slice of the scale used."""
    x32 = x.float()
    scale = p["scale"]
    if group is None:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        ss = x32.square().sum(dim=-1, keepdim=True)
        ss = parallel.reduce_from(parallel.copy_to(ss, group), group)
        var = ss / width
        scale = parallel.rank_part(scale, group, 0, c0, x.shape[-1])
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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
    """Token embeddings.  A vocab-sharded ``w`` (its rows over "model")
    looks up the rank's rows, zeroes the other tokens' and all-reduces."""
    w = p["w"]
    lay = parallel.layout_of(w)
    if lay is None or lay.dim_of("model") != 0:
        return torch.nn.functional.embedding(tokens.long(), w)
    group = parallel.axis_group(lay.mesh, "model")
    v0 = torch.distributed.get_rank(group) * w.shape[0]
    t = tokens.long() - v0
    mine = (t >= 0) & (t < w.shape[0])
    e = torch.nn.functional.embedding(torch.where(mine, t, 0), w)
    return parallel.reduce_from(e * mine[..., None].to(e.dtype), group)


def lm_head_apply(p: dict, x: Tensor) -> Tensor:
    """Logits. ``p`` may be a tied embedding ({'w': (V, d)}) or a linear.
    A vocab-sharded head (the linear's columns, the embedding's rows)
    gives the rank's vocab columns (:func:`head_vocab_shard`)."""
    w = p["w"].to(x.dtype)
    lay = parallel.layout_of(p["w"])
    # a tied embedding (V, d), told by the full shape
    tied = (w.shape if lay is None else lay.shape)[0] != x.shape[-1]
    shard = head_vocab_shard(p)
    if shard is not None:
        x = parallel.copy_to(x, shard[0])
    return x @ w.T if tied else x @ w


def head_vocab_shard(p: dict):
    """``(group, first vocab column)`` of a head whose vocab dim is
    sharded over "model" (a head's columns, a tied embedding's rows), or
    None for a whole vocab."""
    lay = parallel.layout_of(p["w"])
    d = None if lay is None else lay.dim_of("model")
    if d is None:
        return None
    group = parallel.axis_group(lay.mesh, "model")
    return group, torch.distributed.get_rank(group) * p["w"].shape[d]


class _VocabParallelLL(torch.autograd.Function):
    """Log-likelihood of ``labels`` under logits whose vocab is sharded
    over ``group``: the max, the sum of exponentials and the target's logit
    reduced over the group; the gradient is each rank's own columns'."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        z = logits.float()
        m = parallel.all_reduce_sum(z.max(dim=-1).values.contiguous(), group,
                                    op=torch.distributed.ReduceOp.MAX)
        e = torch.exp(z - m[..., None])
        t = labels.long() - v0
        mine = (t >= 0) & (t < z.shape[-1])
        tc = torch.where(mine, t, 0)
        tgt = z.gather(-1, tc[..., None])[..., 0] * mine
        sums = parallel.all_reduce_sum(torch.stack([e.sum(dim=-1), tgt]),
                                       group)
        ctx.save_for_backward(e / sums[0][..., None], tc, mine)
        ctx.dtype = logits.dtype
        return sums[1] - m - torch.log(sums[0])

    @staticmethod
    def backward(ctx, g):
        probs, tc, mine = ctx.saved_tensors
        grad = -probs * g[..., None]
        grad.scatter_add_(-1, tc[..., None], (g * mine)[..., None])
        return grad.to(ctx.dtype), None, None, None


def vocab_parallel_ll(logits: Tensor, labels: Tensor, shard) -> Tensor:
    """Per-position log-likelihood of ``labels`` (clamped at 0) from the
    rank's vocab columns ``logits`` (``shard``: :func:`head_vocab_shard`)."""
    group, v0 = shard
    return _VocabParallelLL.apply(logits, labels.clamp_min(0), v0, group)
