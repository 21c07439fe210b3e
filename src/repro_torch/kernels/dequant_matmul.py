"""CUDA dequant-matmul: ``y = x @ ((codes - z) * s)`` on packed INT weights,
and its fused LoRA variant ``y = x @ ((codes - z) * s) + (x @ A) @ B^T``.

Ports of the Pallas TPU kernels ``repro.kernels.dequant_matmul.
dequant_matmul`` and ``dequant_matmul_lora``; the kernels themselves are
``csrc/dequant_matmul.cu`` (decode-shaped: few rows, bound by bytes) and
``csrc/dequant_matmul_lora.cu`` (training-shaped: M and N tiled, bound by
operations); their headers say what bounds each and how it is laid out.
This module checks the operands, picks each kernel's route and tiling
(:func:`dqmm_plan`, :func:`lora_plan`), allocates the output and scratch,
and launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "dequant_matmul.cu"
LORA_SOURCE = "dequant_matmul_lora.cu"
_C = build.constants(SOURCE)
_UNIT = _C["UNIT"]   # fma route: K rows per staged unit
_BLOCKS_PER_SM = 4   # fma route's grid target: about this many blocks an SM
# mma route: output columns a block, K rows a stage, rows of x at most,
# cluster size at most (portable)
_MMA_BN, _MMA_BK = _C["MMA_BN"], _C["MMA_BK"]
_MMA_MAX_M, _MMA_MAX_SPLITS = _C["MMA_MAX_M"], _C["MMA_MAX_SPLITS"]
_MMA_GRID_SHARE = 0.625  # the mma route's grid: about this share of the SMs
DQMM_ROUTES = {"fma": 0, "mma": 1}     # csrc: route
MAX_LORA_RANK = 128  # csrc/dequant_matmul_lora.cu: 16 * MAX_RPT
# csrc/dequant_matmul_lora.cu: the fma and mma kernels' 64 x 128 tiles (BM,
# BN; one grid row of blocks per 64 rows of x), the wgmma kernel's tiles of
# 128 output columns (WG_BN) by 128 or 64 rows of x, its 64-row K stages
# (WG_BK), the x @ A prologue's 64-row blocks (XA_BM)
_LC = build.constants(LORA_SOURCE)
_SYNC_TILE = (_LC["BM"], _LC["BN"])
_WG_BN, _WG_BK, _XA_BM = _LC["WG_BN"], _LC["WG_BK"], _LC["XA_BM"]
_WG_CB = _LC["WG_CB"]  # stages a zero-correction block
_WG_ROWS = (128, 64)  # the wgmma kernel's instances: rows of x a tile
_XA_MAX_SPLITS = 8   # the prologue's cluster: at most 8 blocks (portable)
_MAX_GRID_ROWS = 65535
LORA_ROUTES = {"fma": 0, "mma": 1, "wgmma": 2}   # csrc: route

# launches of each CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0
lora_launches = 0

_argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
_lora_argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
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


@dataclass(frozen=True)
class DqmmPlan:
    """How ``dequant_matmul_cuda`` runs one call.  ``route`` "mma" (bf16 x
    of at most 8 rows, operands TMA can address: tensor cores, K split over
    a cluster of ``splits`` blocks of ``per_split`` stages of 256 rows,
    one launch) or "fma" (CUDA cores, ``bm`` rows of x and ``cpt`` columns of
    a thread a block, K split over the grid in ``splits`` ranges of
    ``per_split`` 128-row units, partial sums added by a second launch
    when ``splits`` > 1); ``blocks`` in the (first) grid, ``launches`` a
    call."""
    route: str
    splits: int
    per_split: int
    blocks: int
    launches: int
    bm: int = 0
    cpt: int = 0


def mma_addressable(M: int, K: int, N: int, group: int,
                    aligned: bool) -> bool:
    """Whether the mma route takes these operands: at most 8 rows of x,
    16-byte row strides for TMA (K % 8 for x, N % 16 for the codes), a
    group that is a multiple of 32 and tiles the 256-row stages (divides
    256 or is a multiple of it), 16-byte aligned bases (``aligned``).  The
    entry point checks the same."""
    return (M <= _MMA_MAX_M and K % 8 == 0 and N % 16 == 0
            and group % 32 == 0
            and (_MMA_BK % group == 0 or group % _MMA_BK == 0) and aligned)


def dqmm_plan(M: int, K: int, N: int, group: int, *, bf16: bool,
              aligned: bool, cpt: int, n_sm: int,
              splits: int | None = None) -> DqmmPlan:
    """The route and tiling of ``dequant_matmul_cuda`` for x (M, K) and N
    output columns on a card of ``n_sm`` SMs; ``cpt`` is the fma route's
    columns a thread (:func:`_columns_per_thread`).

    bf16 x that :func:`mma_addressable` takes runs on the tensor cores in
    one launch: 128-column tiles, each split over K into cluster blocks (at
    most 8, at least one 256-row stage a block), a power of two nearest
    (in ratio) to 5/8 of ``n_sm`` blocks in all: on an H100 that split was
    the fastest of 1, 2, 4 and 8 at each Qwen3-1.7B linear
    (``chip_smoke.py`` ``dequant_splits``); more blocks cost more in the
    cluster's combine and in sharing SMs than they gain in loads in
    flight.  ``splits`` asks for that many blocks a cluster instead (the
    ``dequant_splits`` timing).  Any f32 zero is taken, on both routes.
    Everything else (f32 x, which must stay f32 within 2e-4; more than 8
    rows; ragged N; other groups) takes the fma route: about four blocks
    an SM, K split over the grid."""
    if bf16 and mma_addressable(M, K, N, group, aligned):
        stages = -(-K // _MMA_BK)
        tiles = -(-N // _MMA_BN)
        if splits is None:
            splits = 2 ** max(0, math.floor(
                math.log2(_MMA_GRID_SHARE * n_sm / tiles) + 0.5))
        want = max(1, min(_MMA_MAX_SPLITS, stages, splits))
        sps = -(-stages // want)
        splits = -(-stages // sps)
        return DqmmPlan("mma", splits, sps, splits * tiles, 1)
    bm = _rows_per_block(M)
    units = -(-K // _UNIT)
    blocks = -(-N // (32 * cpt)) * -(-M // bm)
    want = max(1, min(units, -(-_BLOCKS_PER_SM * n_sm // blocks)))
    ups = -(-units // want)
    splits = -(-units // ups)
    return DqmmPlan("fma", splits, ups, blocks * splits,
                    2 if splits > 1 else 1, bm, cpt)


@dataclass(frozen=True)
class LoraPlan:
    """How the fused kernel runs one call: ``route`` ("wgmma", "mma" or
    "fma"), ``bm`` x ``bn`` output tiles, ``tiles`` of them over ``grid``
    blocks (the wgmma route's blocks are persistent and loop over tiles),
    and the x @ A prologue's K split: ``xa_splits`` ranges of ``xa_chunk``
    rows (wgmma route only)."""
    route: str
    bm: int
    bn: int
    tiles: int
    grid: int
    xa_splits: int = 0
    xa_chunk: int = 0


def tma_addressable(K: int, N: int, r: int, group: int,
                    aligned: bool) -> bool:
    """Whether the wgmma route takes these operands: 16-byte row strides
    for TMA (K % 8, N % 16, r % 8), 16-byte aligned bases (``aligned``),
    and a group of whole 64-row stages (group % 64 == 0: the route folds
    each group's sums at a stage's end).  The entry point checks the
    same."""
    return (K % 8 == 0 and N % 16 == 0 and r % 8 == 0
            and group % _WG_BK == 0 and aligned)


def _fill(tiles: int, n_sm: int) -> float:
    """Share of the SM slots that ``tiles`` persistent tiles keep busy."""
    return tiles / (-(-tiles // n_sm) * n_sm)


def lora_plan(M: int, K: int, N: int, r: int, group: int, *, bf16: bool,
              aligned: bool, n_sm: int) -> LoraPlan:
    """The route and tiling of ``dequant_matmul_lora_cuda`` for x (M, K),
    N output columns, rank r and the quantization group, chosen by shape.

    Every route computes with the reference's f32 weight.  f32 x takes
    the fma route (the only one within the f32 tolerance); bf16 x takes
    wgmma where :func:`tma_addressable` (so groups of 16 and 32 do not:
    they go to mma), else mma where the group is a multiple of 8 (the
    route folds each group's sums after a k16 step or a k8 half), else
    fma (CUDA cores on the f32 weight; no model config has such a
    group).  The wgmma tiles
    are 128 output columns by 128 rows of x, or by 64 where that fills
    clearly more of the ``n_sm`` SMs (Qwen3-1.7B's k/v projections at 1024
    rows: 128 tiles, not 64) or x has at most 64 rows; one persistent
    block per SM.  The prologue (x @ A and each 64-row stage's sums of x)
    splits K over a cluster of up to 8 blocks, so that about one block an
    SM runs."""
    if not bf16 or not tma_addressable(K, N, r, group, aligned):
        route = "mma" if bf16 and group % 8 == 0 else "fma"
        bm, bn = _SYNC_TILE
        rows = -(-M // bm)
        if rows > _MAX_GRID_ROWS:
            raise ValueError(f"dequant_matmul_lora: {M} rows of x are too "
                             f"many for the {route} route's grid")
        tiles = rows * -(-N // bn)
        return LoraPlan(route, bm, bn, tiles, tiles)
    cols = -(-N // _WG_BN)
    big, small = _WG_ROWS
    bm = small if (M <= small or _fill(-(-M // small) * cols, n_sm)
                   > _fill(-(-M // big) * cols, n_sm) + 0.1) else big
    tiles = -(-M // bm) * cols
    chunks = -(-K // _WG_BK)
    want = max(1, min(chunks, _XA_MAX_SPLITS, -(-n_sm // -(-M // _XA_BM))))
    per = -(-chunks // want)
    return LoraPlan("wgmma", bm, _WG_BN, tiles, min(tiles, n_sm),
                    -(-chunks // per), per * _WG_BK)


def lora_plan_for(x2: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
                  lora_a: Tensor, lora_b: Tensor, group: int) -> LoraPlan:
    """:func:`lora_plan` for these operands (x2 is (M, K)) on their card."""
    (M, K), r = x2.shape, lora_a.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, packed, scales, zeros)
                  + ((lora_a, lora_b) if r else ()))
    return lora_plan(M, K, packed.shape[-1], r, group,
                     bf16=x2.dtype == torch.bfloat16, aligned=aligned,
                     n_sm=build.sm_count(x2.device))


def _columns_per_thread(N: int, packed: Tensor, scales: Tensor,
                        zeros: Tensor) -> int:
    """4 when a thread can load its 4 columns as one 32-bit word of
    ``packed`` and one 16-byte vector of ``scales``/``zeros``, else 1."""
    wide = (N % 4 == 0 and packed.data_ptr() % 4 == 0
            and scales.data_ptr() % 16 == 0 and zeros.data_ptr() % 16 == 0)
    return 4 if wide else 1


def plan_for(x2: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
             group: int) -> DqmmPlan:
    """:func:`dqmm_plan` for these operands (x2 is (M, K)) on their card."""
    (M, K), N = x2.shape, packed.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, packed, scales, zeros))
    return dqmm_plan(M, K, N, group, bf16=x2.dtype == torch.bfloat16,
                     aligned=aligned,
                     cpt=_columns_per_thread(N, packed, scales, zeros),
                     n_sm=build.sm_count(x2.device))


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
                        zeros: Tensor, *, bits: int, group_size: int | None,
                        plan: DqmmPlan | None = None) -> Tensor:
    """Launch the kernel.  x (..., K) f32 or bf16 on a CUDA device; packed
    (K*bits/8, N) uint8 for bits 2/4 (K, N) for 8; scales/zeros
    (K/g, N) f32, any values.  ``plan`` replaces :func:`plan_for`'s (to
    time another split); the entry point checks it.  Raises on anything
    the kernel does not take."""
    global launches
    x2, M, N, g = _check_operands("dequant_matmul", x, packed, scales, zeros,
                                  bits, group_size)
    K = x.shape[-1]
    lead = x.shape[:-1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    if plan is None:
        plan = plan_for(x2, packed, scales, zeros, g)
    partial = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                           device=x.device) if plan.launches > 1 else None)
    fn = _lib()
    rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            M, K, N, bits, g, DQMM_ROUTES[plan.route], plan.bm, plan.cpt,
            plan.splits, plan.per_split, int(x.dtype == torch.bfloat16),
            build.stream_handle(x.device))
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
    lead = x.shape[:-1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    plan = lora_plan_for(x2, packed, scales, zeros, lora_a, lora_b, g)
    hl = gz = None
    if plan.route == "wgmma":   # the prologue's outputs: x @ A as hi / lo,
        # and each 64-row stage's sums of x as hi / lo, hi, lo: 4 * _WG_CB
        # columns a correction block of _WG_CB stages
        if r:
            hl = torch.empty((2 * M, r), dtype=torch.bfloat16, device=x.device)
        gz = torch.empty((M, -(-K // (_WG_BK * _WG_CB)) * 4 * _WG_CB),
                         dtype=torch.bfloat16, device=x.device)
    rc = _lora_lib()(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                     zeros.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
                     out.data_ptr(), None if hl is None else hl.data_ptr(),
                     None if gz is None else gz.data_ptr(),
                     M, K, N, bits, g, r, LORA_ROUTES[plan.route],
                     int(x.dtype == torch.bfloat16), plan.bm, plan.grid,
                     plan.xa_splits, plan.xa_chunk,
                     build.stream_handle(x.device))
    build.check(rc, f"{what} launch")
    lora_launches += 1
    return out.reshape(*lead, N)
