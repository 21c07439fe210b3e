"""CUDA Gram matrix: ``H = X^T X`` in f32.

Port of the Pallas TPU kernel ``repro.kernels.gram.gram``; the kernel
itself is ``csrc/gram.cu`` (its header says what bounds it and how it is
laid out).  This module checks the operand, allocates the output and
launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "gram.cu"
_TILE = 64              # output tile edge (csrc: TILE)

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _lib():
    fn = build.load(SOURCE).gram_launch
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def gram_cuda(x: Tensor) -> Tensor:
    """Launch the kernel.  x (T, D) contiguous, f32 or bf16, on a CUDA
    device.  Returns (D, D) f32.  Raises on anything the kernel does not
    take."""
    global launches
    if not build.is_cuda(x):
        raise ValueError("gram: x is not on a CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gram: x dtype {x.dtype} not f32/bf16")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"gram: x must be a contiguous (T, D) matrix, got "
                         f"{tuple(x.shape)}")
    T, D = x.shape
    if D > _TILE * 65535 or T >= 2 ** 31:
        raise ValueError(f"gram: x {tuple(x.shape)} is too large")
    if T == 0 or D == 0:
        return torch.zeros((D, D), dtype=torch.float32, device=x.device)
    out = torch.empty((D, D), dtype=torch.float32, device=x.device)
    rc = _lib()(x.data_ptr(), out.data_ptr(), T, D,
                int(x.dtype == torch.bfloat16), build.stream_handle(x.device))
    build.check(rc, "gram launch")
    launches += 1
    return out
