"""Dispatch wrappers called from model code.

The device decides: a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the hand-written
kernel, for every shape, or the wrapper raises.  Nothing falls back from a
CUDA tensor to the plain version.  A meta tensor (the dry run,
``launch/dryrun.py``) takes the plain version's shapes: nothing runs.

``dequant_matmul`` and ``dequant_matmul_lora`` are differentiable
(``torch.autograd.Function``) when a gradient is asked for: the forward
dispatches by device, the backward is plain PyTorch on either device, as in
the JAX package, where these gradients are autodiff of XLA dots outside any
Pallas kernel.  The packed base gets no gradient.  Without a gradient (the
serve path) they call the forward directly.

Under a gradient the forward goes through a ``torch.library`` custom op
(``repro_torch::dequant_matmul`` and ``repro_torch::dequant_matmul_lora``):
the kernels are launched through ``ctypes``, which no dispatch mode sees,
and the op makes each call one op whose output a selective checkpoint can
keep (``ModelConfig.remat="dots"``).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core.quantizer import dequantize_int, unpack_codes
from repro_torch.kernels import build, ref
from repro_torch.kernels import dequant_matmul as _dqmm
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gram as _gram

Tensor = torch.Tensor

# kernel name -> (module, name of its launch counter)
KERNELS = {"dequant_matmul": (_dqmm, "launches"),
           "dequant_matmul_lora": (_dqmm, "lora_launches"),
           "flash_attention": (_flash, "launches"),
           "gram": (_gram, "launches")}

# rows of x from which a packed-INT linear with 2-D LoRA runs the fused
# dequant_matmul_lora kernel rather than dequant_matmul plus the unfused
# LoRA term: on an H100 the fused kernel is the faster route at 64 rows
# and above, the unfused one at 16 and below (chip_smoke.py,
# ``lora_route``); decode (4 rows) stays unfused, training (1024) fuses
FUSED_LORA_MIN_ROWS = 64


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset, replays of
    captured CUDA graphs included (:func:`add_replayed`)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


@contextlib.contextmanager
def captured_launches() -> Iterator[dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit, the
    launches each wrapper recorded into the graph, and takes them back out
    of :func:`launch_counts` (a capture runs nothing).  Each replay of the
    graph then adds them with :func:`add_replayed`."""
    before = launch_counts()
    got: dict[str, int] = {}
    try:
        yield got
    finally:
        after = launch_counts()
        got.update({k: after[k] - before[k] for k in after})
        for name, (mod, attr) in KERNELS.items():
            setattr(mod, attr, before[name])


def add_replayed(counts: dict[str, int]) -> None:
    """Count one replay of a graph that holds ``counts`` launches."""
    for name, n in counts.items():
        mod, attr = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def _plain(t: Tensor) -> bool:
    if build.is_cuda(t):
        return False
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return True


def _dequantized(packed: Tensor, scales: Tensor, zeros: Tensor, bits: int,
                 group_size: int | None, K: int) -> Tensor:
    """The (K, N) weight in f32, by the plain unpack and dequantize."""
    return dequantize_int(unpack_codes(packed, bits, K), scales, zeros,
                          group_size, dtype=torch.float32)


def _dequant_matmul(x, packed, scales, zeros, bits, group_size):
    if _plain(x):
        return ref.dequant_matmul_ref(x, packed, scales, zeros, bits=bits,
                                      group_size=group_size)
    return _dqmm.dequant_matmul_cuda(x, packed, scales, zeros, bits=bits,
                                     group_size=group_size)


def _dequant_matmul_lora(x, packed, scales, zeros, lora_a, lora_b, bits,
                         group_size):
    if _plain(x):
        return ref.dequant_matmul_lora_ref(x, packed, scales, zeros, lora_a,
                                           lora_b, bits=bits,
                                           group_size=group_size)
    return _dqmm.dequant_matmul_lora_cuda(x, packed, scales, zeros, lora_a,
                                          lora_b, bits=bits,
                                          group_size=group_size)


@torch.library.custom_op("repro_torch::dequant_matmul", mutates_args=())
def _dequant_matmul_op(x: Tensor, packed: Tensor, scales: Tensor,
                       zeros: Tensor, bits: int,
                       group_size: Optional[int]) -> Tensor:
    return _dequant_matmul(x, packed, scales, zeros, bits, group_size)


@_dequant_matmul_op.register_fake
def _(x, packed, scales, zeros, bits, group_size):
    return x.new_empty((*x.shape[:-1], packed.shape[-1]))


@torch.library.custom_op("repro_torch::dequant_matmul_lora", mutates_args=())
def _dequant_matmul_lora_op(x: Tensor, packed: Tensor, scales: Tensor,
                            zeros: Tensor, lora_a: Tensor, lora_b: Tensor,
                            bits: int, group_size: Optional[int]) -> Tensor:
    return _dequant_matmul_lora(x, packed, scales, zeros, lora_a, lora_b,
                                bits, group_size)


@_dequant_matmul_lora_op.register_fake
def _(x, packed, scales, zeros, lora_a, lora_b, bits, group_size):
    return x.new_empty((*x.shape[:-1], packed.shape[-1]))


def _wants_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _DequantMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, scales, zeros, bits, group_size):
        ctx.save_for_backward(packed, scales, zeros)
        ctx.bits, ctx.group_size, ctx.x_shape = bits, group_size, x.shape
        return _dequant_matmul_op(x, packed, scales, zeros, bits, group_size)

    @staticmethod
    def backward(ctx, g):
        packed, scales, zeros = ctx.saved_tensors
        K = ctx.x_shape[-1]
        w = _dequantized(packed, scales, zeros, ctx.bits, ctx.group_size, K)
        dx = (g.float() @ w.T).to(g.dtype).reshape(ctx.x_shape)
        return dx, None, None, None, None, None


class _DequantMatmulLora(torch.autograd.Function):
    """y = x @ Wq + (x @ A) @ B^T; gradients in f32, cast to each input's
    dtype: with xa = x @ A (recomputed) and gB = g @ B,
    dB = g^T @ xa, dA = x^T @ gB, dx = g @ Wq^T + gB @ A^T."""

    @staticmethod
    def forward(ctx, x, packed, scales, zeros, lora_a, lora_b, bits,
                group_size):
        ctx.save_for_backward(x, packed, scales, zeros, lora_a, lora_b)
        ctx.bits, ctx.group_size = bits, group_size
        return _dequant_matmul_lora_op(x, packed, scales, zeros, lora_a,
                                       lora_b, bits, group_size)

    @staticmethod
    def backward(ctx, g):
        x, packed, scales, zeros, a, b = ctx.saved_tensors
        K = x.shape[-1]
        x2 = x.reshape(-1, K).float()
        g2 = g.reshape(-1, g.shape[-1]).float()
        a32 = a.float()
        gb = g2 @ b.float()
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            w = _dequantized(packed, scales, zeros, ctx.bits, ctx.group_size,
                             K)
            dx = (g2 @ w.T + gb @ a32.T).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[4]:
            da = (x2.T @ gb).to(a.dtype)
        if ctx.needs_input_grad[5]:
            db = (g2.T @ (x2 @ a32)).to(b.dtype)
        return dx, None, None, None, da, db, None, None


def dequant_matmul(x: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
                   *, bits: int, group_size: int | None) -> Tensor:
    if _wants_grad(x):
        return _DequantMatmul.apply(x, packed, scales, zeros, bits,
                                    group_size)
    return _dequant_matmul(x, packed, scales, zeros, bits, group_size)


def dequant_matmul_lora(x: Tensor, packed: Tensor, scales: Tensor,
                        zeros: Tensor, lora_a: Tensor, lora_b: Tensor, *,
                        bits: int, group_size: int | None) -> Tensor:
    """Fused ``x @ Wq + (x @ lora_a) @ lora_b^T``; lora_a (K, r), lora_b
    (N, r).  Differentiable in x, lora_a and lora_b."""
    if _wants_grad(x, lora_a, lora_b):
        return _DequantMatmulLora.apply(x, packed, scales, zeros, lora_a,
                                        lora_b, bits, group_size)
    return _dequant_matmul_lora(x, packed, scales, zeros, lora_a, lora_b,
                                bits, group_size)


def gram(x: Tensor) -> Tensor:
    """H = X^T X in f32 for x (..., D) flattened to (T, D)."""
    x2 = x.reshape(-1, x.shape[-1])
    if _plain(x2):
        return ref.gram_ref(x2)
    return _gram.gram_cuda(x2.contiguous())


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    lengths: Tensor | None = None, return_lse: bool = False):
    """``return_lse``: the partial mode, ``(out, lse)`` (lengths may be 0;
    ``ref.flash_attention_ref``)."""
    if _plain(q):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       lengths=lengths, return_lse=return_lse)
    return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                       lengths=lengths, return_lse=return_lse)
