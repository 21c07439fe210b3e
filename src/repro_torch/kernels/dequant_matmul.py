"""CUDA dequant-matmul: ``y = x @ ((codes - z) * s)`` on packed INT weights,
and its fused LoRA variant ``y = x @ ((codes - z) * s) + (x @ A) @ B^T``.

Ports of the Pallas TPU kernels ``repro.kernels.dequant_matmul.
dequant_matmul`` and ``dequant_matmul_lora``; the kernels themselves are
``csrc/dequant_matmul.cu`` (decode-shaped: few rows, bound by bytes) and
``csrc/dequant_matmul_lora.cu`` (training-shaped: M and N tiled, bound by
operations); their headers say what bounds each and how it is laid out.
This module checks the operands, sizes the grid, allocates the output and
scratch, and launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "dequant_matmul.cu"
LORA_SOURCE = "dequant_matmul_lora.cu"
_UNIT = 128          # K rows per staged unit (csrc: UNIT)
_BLOCKS_PER_SM = 4   # grid target: about this many blocks per SM
MAX_LORA_RANK = 128  # csrc/dequant_matmul_lora.cu: 16 * MAX_RPT
_LORA_BM = 64        # rows of x per block of the fused kernel (csrc: BM)

# launches of each CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0
lora_launches = 0

_argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_lora_argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])


def _lib():
    lib = build.load(SOURCE)
    fn = lib.dqmm_launch
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def _lora_lib():
    fn = build.load(LORA_SOURCE).dqmm_lora_launch
    fn.argtypes = _lora_argtypes
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


def _check_operands(what: str, x: Tensor, packed: Tensor, scales: Tensor,
                    zeros: Tensor, bits: int, group_size: int | None,
                    lora: tuple[tuple[str, Tensor], ...] = ()
                    ) -> tuple[Tensor, int, int, int]:
    """Validate the operands both kernels share (and the LoRA factors, which
    must have x's dtype).  Returns (x as (M, K), M, N, group)."""
    K = x.shape[-1]
    N = packed.shape[-1]
    g = K if group_size is None else int(group_size)
    per = {2: 4, 4: 2, 8: 1}.get(bits)
    named = (("x", x), ("packed", packed), ("scales", scales),
             ("zeros", zeros)) + lora
    for name, t in named:
        if not build.is_cuda(t):
            raise ValueError(f"{what}: {name} is not on a CUDA device")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if per is None:
        raise ValueError(f"{what}: bits={bits} not in (2, 4, 8)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x dtype {x.dtype} not f32/bf16")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32 or \
            zeros.dtype != torch.float32:
        raise TypeError(f"{what}: packed must be uint8, scales and zeros f32")
    for name, t in lora:
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: {name} dtype {t.dtype} is not x's "
                            f"{x.dtype}")
    if g < 1 or K % g or K % per or packed.dim() != 2 or \
            packed.shape[0] * per != K:
        raise ValueError(f"{what}: packed {tuple(packed.shape)} does not hold "
                         f"K={K} rows at {bits} bits, or group {g} does not "
                         "divide K")
    if tuple(scales.shape) != (K // g, N) or tuple(zeros.shape) != (K // g, N):
        raise ValueError(f"{what}: scales/zeros must be {(K // g, N)}")
    M = math.prod(x.shape[:-1])
    x2 = x.reshape(M, K)
    for name, t in (("x", x2),) + named[1:]:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return x2, M, N, g


def dequant_matmul_cuda(x: Tensor, packed: Tensor, scales: Tensor,
                        zeros: Tensor, *, bits: int,
                        group_size: int | None) -> Tensor:
    """Launch the kernel.  x (..., K) f32 or bf16 on a CUDA device; packed
    (K*bits/8, N) uint8 for bits 2/4 (K, N) for 8; scales/zeros
    (K/g, N) f32.  Raises on anything the kernel does not take."""
    global launches
    x2, M, N, g = _check_operands("dequant_matmul", x, packed, scales, zeros,
                                  bits, group_size)
    K = x.shape[-1]
    lead = x.shape[:-1]
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


def dequant_matmul_lora_cuda(x: Tensor, packed: Tensor, scales: Tensor,
                             zeros: Tensor, lora_a: Tensor, lora_b: Tensor, *,
                             bits: int, group_size: int | None) -> Tensor:
    """Launch the fused kernel.  Operands as :func:`dequant_matmul_cuda`,
    plus lora_a (K, r) and lora_b (N, r) in x's dtype, 0 <= r <= 128.
    Returns (..., N) in x.dtype.  Raises on anything the kernel does not
    take."""
    global lora_launches
    what = "dequant_matmul_lora"
    x2, M, N, g = _check_operands(what, x, packed, scales, zeros, bits,
                                  group_size, (("lora_a", lora_a),
                                               ("lora_b", lora_b)))
    K = x.shape[-1]
    r = lora_a.shape[-1] if lora_a.dim() == 2 else -1
    if lora_a.dim() != 2 or lora_b.dim() != 2 or lora_a.shape[0] != K or \
            tuple(lora_b.shape) != (N, r):
        raise ValueError(f"{what}: lora_a must be (K, r) = ({K}, r) and "
                         f"lora_b (N, r) = ({N}, r); got "
                         f"{tuple(lora_a.shape)}, {tuple(lora_b.shape)}")
    if r > MAX_LORA_RANK:
        raise ValueError(f"{what}: rank {r} > {MAX_LORA_RANK}")
    if -(-M // _LORA_BM) > 65535:
        raise ValueError(f"{what}: {M} rows of x are too many")
    lead = x.shape[:-1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    rc = _lora_lib()(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                     zeros.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
                     out.data_ptr(), M, K, N, bits, g, r,
                     int(x.dtype == torch.bfloat16),
                     build.stream_handle(x.device))
    build.check(rc, f"{what} launch")
    lora_launches += 1
    return out.reshape(*lead, N)
