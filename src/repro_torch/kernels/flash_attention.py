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
# the kernel's query rows (warps) a block at most, the split route's cluster
# size at most (portable), keys a warp scores per tile, ring stages, the
# shared memory a block may use and the partials a query row combines at
# most (splits x key groups)
_C = build.constants(SOURCE)
_ROWS, _MAX_SPLITS, _SPLIT_KEYS, _STAGES = (
    _C["ROWS"], _C["MAX_SPLITS"], _C["SPLIT_KEYS"], _C["STAGES"])
_SMEM_MAX, _MAX_PARTS = _C["SMEM_MAX"], _C["MAX_PARTS"]

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0

_argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


@dataclass(frozen=True)
class FlashPlan:
    """How the kernel runs one call: ``route`` "mma" or "split" (Sq = 1:
    the keys of each (batch, KV head) split over a cluster of ``splits``
    blocks, ``chunk`` keys each, ``kw`` key groups of warps a block; "mma"
    scores and sums on the tensor cores, "split" on the CUDA cores) or
    "tiled" (one block per (batch, KV head, query tile)); ``blocks`` in
    the grid.  Every route is one launch."""
    route: str
    blocks: int
    splits: int = 0
    chunk: int = 0
    kw: int = 0
    launches: int = 1


def _split_smem(elem: int, d: int, hpb: int, kw: int) -> int:
    """csrc: split_smem, for the head dim padded to a power of two >= 32."""
    D = max(32, 1 << (d - 1).bit_length())
    ldr = D + 16 // elem
    return (_STAGES * _SPLIT_KEYS * kw * 2 * ldr * elem + hpb * D * 4
            + kw * hpb * (D + 4) * 4 + _ROWS * (_MAX_PARTS + 1) * 4)


def flash_plan(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, d: int, *,
               elem: int, vec: bool, n_sm: int) -> FlashPlan:
    """The route and split of :func:`flash_attention_cuda` for these
    shapes, ``elem``-byte elements and ``vec`` (16-byte loads possible,
    :func:`_vector_loads`) on a card of ``n_sm`` SMs.

    A single query row (decode) with 16-byte loads splits each (batch, KV
    head)'s keys over a cluster of ``splits`` blocks, ``chunk`` keys each
    (a multiple of 32), never from ``lengths``.  bf16 with d of 64 or 128
    takes the mma route: one warp a block holds every query row of the KV
    head on the tensor cores, three more load, and the split aims at two
    blocks an SM.  The rest takes the split route: a warp a query row on
    the CUDA cores, ``kw`` key groups of warps sharing each tile (one per
    32 keys of the range, up to 4, within 16 partials a query row and
    shared memory), about one block an SM.  On an H100 these were the
    fastest of 4 or 8 splits and 1, 2 or 4 key groups at 128- and
    4096-key caches.  Everything else takes the tiled route."""
    rep = Hq // Hkv
    hpb = min(rep, _ROWS)
    groups = B * Hkv * -(-rep // hpb)
    D = max(32, 1 << (d - 1).bit_length())
    if Sq != 1 or not vec or d % (D // 32):
        bq = min(_ROWS // hpb, Sq)
        return FlashPlan("tiled", -(-Sq // bq) * groups)
    mma = elem == 2 and d in (64, 128)
    # about one block an SM (two on the mma route, whose blocks are small)
    want = max(1, min(_MAX_SPLITS, (2 if mma else 1) * n_sm // groups,
                      -(-Sk // _SPLIT_KEYS)))
    chunk = -(-(-(-Sk // want)) // _SPLIT_KEYS) * _SPLIT_KEYS
    splits = -(-Sk // chunk)
    if mma:
        # tensor cores: one warp takes every query row of the KV head and
        # every tile; three more only load
        return FlashPlan("mma", splits * groups, splits, chunk, 1)
    # CUDA cores: a warp a query row; key groups: one per 32 keys of a
    # block's range, up to 8 warps a block, 16 partials a query row and
    # what shared memory holds
    kw = min(4, max(1, 8 // hpb), -(-chunk // _SPLIT_KEYS),
             _MAX_PARTS // splits)
    kw = 1 << (kw.bit_length() - 1)     # 1, 2 or 4
    while kw > 1 and _split_smem(elem, d, hpb, kw) > _SMEM_MAX:
        kw //= 2
    return FlashPlan("split", splits * groups, splits, chunk, kw)


def plan_for(q: Tensor, k: Tensor, v: Tensor) -> FlashPlan:
    """:func:`flash_plan` for these operands on their card."""
    B, Hq, Sq, d = q.shape
    return flash_plan(B, Hq, k.shape[1], Sq, k.shape[2], d,
                      elem=q.element_size(), vec=_vector_loads(k, v),
                      n_sm=build.sm_count(q.device))


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
                         return_lse: bool = False):
    """Launch the kernel.  q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d), all of one
    dtype (f32 or bf16) on one CUDA device; ``lengths`` (B,) int32 >= 1 or
    None.  Returns (B, Hq, Sq, d) contiguous in q.dtype.

    ``return_lse`` (the partial mode of the sequence-sharded decode):
    ``(out, lse)``, ``out`` in f32 (the ranks' partials are combined in
    f32 and rounded once) and each query row's log-sum-exp over its
    valid keys, (B, Hq, Sq) f32 in the natural-log units of the scaled
    logits, on the same route and in the same launch; ``lengths`` may
    then hold 0, and such a row gives out 0 and lse -inf."""
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
            int(plan.route == "mma"), build.stream_handle(q.device))
    build.check(rc, "flash_attention launch")
    launches += 1
    return (out, lse) if return_lse else out
