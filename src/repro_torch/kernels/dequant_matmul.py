"""CUDA dequant-matmul: ``y = x @ ((codes - z) * s)`` on packed INT weights.

Port of the Pallas TPU kernel ``repro.kernels.dequant_matmul.dequant_matmul``;
the kernel itself is ``csrc/dequant_matmul.cu`` (its header says what bounds
it and how it is laid out).  This module checks the operands, sizes the K
split, allocates the output and scratch, and launches on PyTorch's current
stream.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "dequant_matmul.cu"
_UNIT = 128          # K rows per staged unit (csrc: UNIT)
_BLOCKS_PER_SM = 4   # grid target: about this many blocks per SM

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0

_argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _lib():
    lib = build.load(SOURCE)
    fn = lib.dqmm_launch
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def _rows_per_block(M: int) -> int:
    return 8 if M >= 8 else 1 << (M - 1).bit_length()


def plan_grid(M: int, K: int, N: int, cpt: int,
              n_sm: int) -> tuple[int, int, int]:
    """(rows of x per block, K splits, 128-row units per split) for a grid
    of about four blocks per SM."""
    bm = _rows_per_block(M)
    units = -(-K // _UNIT)
    blocks = -(-N // (32 * cpt)) * -(-M // bm)
    want = max(1, min(units, -(-_BLOCKS_PER_SM * n_sm // blocks)))
    ups = -(-units // want)
    return bm, -(-units // ups), ups


def _columns_per_thread(N: int, packed: Tensor, scales: Tensor,
                        zeros: Tensor) -> int:
    """4 when a thread can load its 4 columns as one 32-bit word of
    ``packed`` and one 16-byte vector of ``scales``/``zeros``, else 1."""
    wide = (N % 4 == 0 and packed.data_ptr() % 4 == 0
            and scales.data_ptr() % 16 == 0 and zeros.data_ptr() % 16 == 0)
    return 4 if wide else 1


def dequant_matmul_cuda(x: Tensor, packed: Tensor, scales: Tensor,
                        zeros: Tensor, *, bits: int,
                        group_size: int | None) -> Tensor:
    """Launch the kernel.  x (..., K) f32 or bf16 on a CUDA device; packed
    (K*bits/8, N) uint8 for bits 2/4 (K, N) for 8; scales/zeros
    (K/g, N) f32.  Raises on anything the kernel does not take."""
    global launches
    K = x.shape[-1]
    N = packed.shape[-1]
    g = K if group_size is None else int(group_size)
    per = {2: 4, 4: 2, 8: 1}.get(bits)
    for name, t in (("x", x), ("packed", packed), ("scales", scales),
                    ("zeros", zeros)):
        if not build.is_cuda(t):
            raise ValueError(f"dequant_matmul: {name} is not on a CUDA device")
        if t.device != x.device:
            raise ValueError(f"dequant_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
    if per is None:
        raise ValueError(f"dequant_matmul: bits={bits} not in (2, 4, 8)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant_matmul: x dtype {x.dtype} not f32/bf16")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32 or \
            zeros.dtype != torch.float32:
        raise TypeError("dequant_matmul: packed must be uint8, scales and "
                        "zeros f32")
    if g < 1 or K % g or K % per or packed.dim() != 2 or \
            packed.shape[0] * per != K:
        raise ValueError(f"dequant_matmul: packed {tuple(packed.shape)} does "
                         f"not hold K={K} rows at {bits} bits, or group {g} "
                         "does not divide K")
    if tuple(scales.shape) != (K // g, N) or tuple(zeros.shape) != (K // g, N):
        raise ValueError(f"dequant_matmul: scales/zeros must be {(K // g, N)}")
    lead = x.shape[:-1]
    M = math.prod(lead)
    x2 = x.reshape(M, K)
    for name, t in (("x", x2), ("packed", packed), ("scales", scales),
                    ("zeros", zeros)):
        if not t.is_contiguous():
            raise ValueError(f"dequant_matmul: {name} must be contiguous")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    cpt = _columns_per_thread(N, packed, scales, zeros)
    bm, splits, ups = plan_grid(M, K, N, cpt, build.sm_count(x.device))
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _lib()
    rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            M, K, N, bits, g, bm, cpt, splits, ups,
            int(x.dtype == torch.bfloat16), build.stream_handle(x.device))
    build.check(rc, "dequant_matmul launch")
    launches += 1
    return out.reshape(*lead, N)
