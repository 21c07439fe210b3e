"""CUDA flash attention: online-softmax GQA with per-sequence ``lengths``.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention``; the kernel itself is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out).  This module checks
the operands, picks the route (:func:`flash_plan`), allocates the output
and launches on PyTorch's current stream.  q, k and v may be strided
views as long as their last dimension is contiguous, so the decode path
passes the KV cache through a transpose without copying it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 256
# the kernel's query rows (warps) a block at most, the cluster size at most
# (portable), keys a tile, the split route's ring stages, the shared
# memory a block may use and the partials a query row combines at most on
# the split route (splits x key groups); the bulk route's consumer warps a
# block and ring stages at most
_C = build.constants(SOURCE)
_ROWS, _MAX_SPLITS, _SPLIT_KEYS, _STAGES = (
    _C["ROWS"], _C["MAX_SPLITS"], _C["SPLIT_KEYS"], _C["STAGES"])
_SMEM_MAX, _MAX_PARTS = _C["SMEM_MAX"], _C["MAX_PARTS"]
_CONSUMERS, _MAX_STAGES = _C["CONSUMERS"], _C["MAX_STAGES"]
# shared memory an SM holds for its blocks (each block's 1 KB reserve
# included): the H100's 228 KB
_SM_SMEM = 233472
# tiles a bulk-route block at least: on an H100 at a 128-key cache, 2
# blocks a cluster of 2 tiles were faster than 4 of 1 tile and 1 of 4
# (chip_smoke.py's time_flash, by_splits)
_BULK_MIN_TILES = 2

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0

_argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


@dataclass(frozen=True)
class FlashPlan:
    """How the kernel runs one call: ``route`` "bulk" or "split" (Sq = 1:
    the keys of each (batch, KV head) split over a cluster of ``splits``
    blocks, ``chunk`` keys each; "bulk" scores and sums on the tensor
    cores from a ring of ``stages`` tiles that a producer fills with TMA,
    "split" on the CUDA cores with ``kw`` key groups of warps a block) or
    "tiled" (one block per (batch, KV head, query tile)); ``blocks`` in
    the grid.  Every route is one launch."""
    route: str
    blocks: int
    splits: int = 0
    chunk: int = 0
    kw: int = 0
    stages: int = 0
    launches: int = 1


def _split_smem(elem: int, d: int, hpb: int, kw: int) -> int:
    """csrc: split_smem, for the head dim padded to a power of two >= 32."""
    D = max(32, 1 << (d - 1).bit_length())
    ldr = D + 16 // elem
    return (_STAGES * _SPLIT_KEYS * kw * 2 * ldr * elem + hpb * D * 4
            + kw * hpb * (D + 4) * 4)


def tile_tx_bytes(d: int) -> int:
    """csrc: tile_tx_bytes, the bytes a bulk-route tile loads (whole TMA
    boxes of 32 keys of K and of V, ``d`` bf16 a key; keys past Sk arrive
    as zeros and count): what its full barrier expects, ragged or not."""
    return 2 * _SPLIT_KEYS * d * 2


def bulk_smem(d: int, hpb: int, stages: int) -> int:
    """csrc: bulk_smem, the bulk route's shared memory a block (bf16, d of
    64 or 128, ``hpb`` query rows, a ring of ``stages`` tiles)."""
    return (1024 + stages * tile_tx_bytes(d) + _ROWS * (d + 8) * 2
            + (_CONSUMERS + 1) * hpb * (d + 4) * 4 + stages * 2 * 8)


def flash_plan(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, d: int, *,
               elem: int, vec: bool, n_sm: int, splits: int | None = None,
               stages: int | None = None) -> FlashPlan:
    """The route and split of :func:`flash_attention_cuda` for these
    shapes, ``elem``-byte elements and ``vec`` (16-byte loads possible,
    :func:`_vector_loads`) on a card of ``n_sm`` SMs.

    A single query row (decode) with 16-byte loads splits each (batch, KV
    head)'s keys over a cluster of ``splits`` blocks, ``chunk`` keys each
    (a multiple of 32), never from ``lengths``.  bf16 with d of 64 or 128
    takes the bulk route: a producer thread streams 32-key tiles into a
    ring of ``stages`` with TMA, and four consumer warps hold every query
    row of the KV head on the tensor cores.  Its split aims at one block
    an SM of at least two tiles, and its ring at as many of the block's
    tiles as the blocks an SM must hold leave room for, up to 8 (4 or 8
    when a block has more tiles than stages).  On an H100 that split was
    the fastest of 1, 2, 4 and 8 blocks a cluster at 128- and 4096-key
    caches and at decode_32k's 2048-key shard (``chip_smoke.py``'s
    ``by_splits`` and ``by_plan``); ``splits`` and ``stages`` ask for
    those instead.  The rest takes the split route: a warp a query row on
    the CUDA cores, ``kw`` key groups of warps sharing each tile (one per
    32 keys of the range, up to 4, within 16 partials a query row and
    shared memory), about one block an SM; on an H100 the fastest of 4 or
    8 splits and 1, 2 or 4 key groups at 128- and 4096-key caches.
    Everything else takes the tiled route."""
    rep = Hq // Hkv
    hpb = min(rep, _ROWS)
    groups = B * Hkv * -(-rep // hpb)
    D = max(32, 1 << (d - 1).bit_length())
    if Sq != 1 or not vec or d % (D // 32):
        bq = min(_ROWS // hpb, Sq)
        return FlashPlan("tiled", -(-Sq // bq) * groups)
    bulk = elem == 2 and d in (64, 128)
    # about one block an SM; a bulk block at least two tiles, so that two
    # of its consumer warps work
    want = splits or max(1, min(
        _MAX_SPLITS, n_sm // groups,
        -(-Sk // (_SPLIT_KEYS * (_BULK_MIN_TILES if bulk else 1)))))
    chunk = -(-(-(-Sk // want)) // _SPLIT_KEYS) * _SPLIT_KEYS
    splits = -(-Sk // chunk)
    if bulk:
        # the ring: the block's tiles up to 8, as deep as the blocks an SM
        # must hold at once leave shared memory for; a ring that a block
        # goes round more than once holds a whole number of tiles a
        # consumer warp (csrc: flash_bulk_kernel)
        tiles = chunk // _SPLIT_KEYS
        per_sm = -(-splits * groups // n_sm)
        room = min(_SMEM_MAX, _SM_SMEM // per_sm - 1024)
        depth = stages or min(_MAX_STAGES, tiles)
        while depth > 1 and bulk_smem(d, hpb, depth) > room:
            depth -= 1
        if depth < tiles:
            depth = max(_CONSUMERS, depth - depth % _CONSUMERS)
        return FlashPlan("bulk", splits * groups, splits, chunk, 0, depth)
    # CUDA cores: a warp a query row; key groups: one per 32 keys of a
    # block's range, up to 8 warps a block, 16 partials a query row and
    # what shared memory holds
    kw = min(4, max(1, 8 // hpb), -(-chunk // _SPLIT_KEYS),
             _MAX_PARTS // splits)
    kw = 1 << (kw.bit_length() - 1)     # 1, 2 or 4
    while kw > 1 and _split_smem(elem, d, hpb, kw) > _SMEM_MAX:
        kw //= 2
    return FlashPlan("split", splits * groups, splits, chunk, kw)


def plan_for(q: Tensor, k: Tensor, v: Tensor, **kw) -> FlashPlan:
    """:func:`flash_plan` for these operands on their card (``kw``: its
    ``splits`` and ``stages``)."""
    B, Hq, Sq, d = q.shape
    return flash_plan(B, Hq, k.shape[1], Sq, k.shape[2], d,
                      elem=q.element_size(), vec=_vector_loads(k, v),
                      n_sm=build.sm_count(q.device), **kw)


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
                         lengths: Tensor | None = None,
                         return_lse: bool = False,
                         plan: FlashPlan | None = None):
    """Launch the kernel.  q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d), all of one
    dtype (f32 or bf16) on one CUDA device; ``lengths`` (B,) int32 >= 1 or
    None.  Returns (B, Hq, Sq, d) contiguous in q.dtype.

    ``return_lse`` (the partial mode of the sequence-sharded decode):
    ``(out, lse)``, ``out`` in f32 (the ranks' partials are combined in
    f32 and rounded once) and each query row's log-sum-exp over its
    valid keys, (B, Hq, Sq) f32 in the natural-log units of the scaled
    logits, on the same route and in the same launch; ``lengths`` may
    then hold 0, and such a row gives out 0 and lse -inf.  ``plan``
    (:func:`plan_for` with its overrides) replaces the plan's choice."""
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
    out = torch.empty((B, Hq, Sq, d), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if plan is None:
        plan = plan_for(q, k, v)
    fn = _lib()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, Sq, Sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 1.0 / d ** 0.5, int(_vector_loads(k, v)),
            int(q.dtype == torch.bfloat16), plan.splits, plan.chunk, plan.kw,
            int(plan.route == "bulk"), plan.stages,
            build.stream_handle(q.device))
    build.check(rc, "flash_attention launch")
    launches += 1
    return (out, lse) if return_lse else out
