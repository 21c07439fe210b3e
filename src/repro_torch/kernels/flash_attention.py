"""CUDA flash attention: online-softmax GQA with per-sequence ``lengths``.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention``; the kernel itself is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out).  This module checks
the operands, allocates the output and launches on PyTorch's current
stream.  q, k and v may be strided views as long as their last dimension
is contiguous, so the decode path passes the KV cache through a transpose
without copying it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 256

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0

_argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def _vector_loads(k: Tensor, v: Tensor) -> bool:
    """Whether K and V can be read 16 bytes per load: aligned pointers,
    and the head dim and every stride a multiple of 16 bytes."""
    per = 16 // k.element_size()
    return (k.shape[-1] % per == 0
            and all(t.data_ptr() % 16 == 0 for t in (k, v))
            and all(st % per == 0 for t in (k, v) for st in t.stride()[:3]))


def _lib():
    lib = build.load(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True,
                         lengths: Tensor | None = None) -> Tensor:
    """Launch the kernel.  q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d), all of one
    dtype (f32 or bf16) on one CUDA device; ``lengths`` (B,) int32 >= 1 or
    None.  Returns (B, Hq, Sq, d) contiguous in q.dtype."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)) + (
            (("lengths", lengths),) if lengths is not None else ()):
        if not build.is_cuda(t):
            raise ValueError(f"flash_attention: {name} is not on a CUDA "
                             "device")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, f32 "
                        "or bf16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,Hq,Sq,d), k/v (B,Hkv,Sk,d)")
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} do not match")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             "contiguous")
    if lengths is not None:
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) or \
                not lengths.is_contiguous():
            raise ValueError("flash_attention: lengths must be (B,) int32")
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 1.0 / d ** 0.5, int(_vector_loads(k, v)),
            int(q.dtype == torch.bfloat16), build.stream_handle(q.device))
    build.check(rc, "flash_attention launch")
    launches += 1
    return out
