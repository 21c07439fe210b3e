"""CUDA Gram matrix: ``H = X^T X`` in f32.

Port of the Pallas TPU kernel ``repro.kernels.gram.gram``; the kernel
itself is ``csrc/gram.cu`` (its header says what bounds it and how it is
laid out).  This module checks the operand, picks the route and tiling
(:func:`gram_plan`), allocates the output and launches on PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

SOURCE = "gram.cu"
_C = build.constants(SOURCE)
_TILE = _C["TILE"]              # fma route: output tile edge
_WG_TILE = _C["WG_TILE"]        # wgmma route: output tile edge
ROUTES = {"fma": 0, "wgmma": 1}  # csrc: route

# launches of the CUDA kernel; reset and read by callers that need to show
# a path went through it
launches = 0
# the same launches by the route the entry point accepted and launched (it
# launches route 1's kernel, the wgmma one, or refuses): a record of which
# kernel ran that needs no profiler
route_launches = {route: 0 for route in ROUTES}

_argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _lib():
    fn = build.load(SOURCE).gram_launch
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


@dataclass(frozen=True)
class GramPlan:
    """How ``gram_cuda`` runs one call: ``route`` "wgmma" (``grid``
    persistent blocks walking the upper triangle's ``tile`` x ``tile``
    tiles, ``tiles`` of them) or "fma" (one block a ``tile`` x ``tile``
    tile of the whole square, ``grid`` = ``tiles`` blocks, those below the
    diagonal exit at once)."""
    route: str
    tile: int
    tiles: int
    grid: int


def wgmma_addressable(D: int, *, bf16: bool, aligned: bool) -> bool:
    """Whether the wgmma route takes x (T, D): bf16, a 16-byte row stride
    (D % 8 == 0) and 16-byte aligned x and output (``aligned``).  The entry
    point checks the same."""
    return bf16 and D % 8 == 0 and aligned


def gram_plan(T: int, D: int, *, bf16: bool, aligned: bool, n_sm: int,
              grid: int | None = None) -> GramPlan:
    """The route and tiling of ``gram_cuda`` for x (T, D) on a card of
    ``n_sm`` SMs.

    bf16 x that :func:`wgmma_addressable` takes runs on the tensor cores:
    the upper triangle's 128 x 128 tiles, one persistent block an SM
    (``chip_smoke.py``'s ``gram_tiles`` line times 1/4 to all of the SMs).
    ``grid`` asks for that many blocks instead, as far as there are
    tiles.  Everything else (f32 x, whose rtol 1e-4 rules out plain TF32;
    a ragged row stride; an unaligned base) takes the fma route: 64 x 64
    tiles on the CUDA cores.  T does not change the plan."""
    if not wgmma_addressable(D, bf16=bf16, aligned=aligned):
        nb = -(-D // _TILE)
        return GramPlan("fma", _TILE, nb * nb, nb * nb)
    nb = -(-D // _WG_TILE)
    tiles = nb * (nb + 1) // 2
    return GramPlan("wgmma", _WG_TILE, tiles,
                    max(1, min(tiles, n_sm if grid is None else grid)))


def plan_for(x: Tensor) -> GramPlan:
    """:func:`gram_plan` for x (T, D) on its card."""
    T, D = x.shape
    return gram_plan(T, D, bf16=x.dtype == torch.bfloat16,
                     aligned=x.data_ptr() % 16 == 0,
                     n_sm=build.sm_count(x.device))


def gram_cuda(x: Tensor, plan: GramPlan | None = None) -> Tensor:
    """Launch the kernel.  x (T, D) contiguous, f32 or bf16, on a CUDA
    device.  Returns (D, D) f32.  ``plan`` replaces :func:`plan_for`'s (to
    time another grid); the entry point checks it.  Raises on anything
    the kernel does not take."""
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
    if plan is None:
        plan = plan_for(x)
    rc = _lib()(x.data_ptr(), out.data_ptr(), T, D,
                int(x.dtype == torch.bfloat16), ROUTES[plan.route], plan.grid,
                build.stream_handle(x.device))
    build.check(rc, "gram launch")
    launches += 1
    route_launches[plan.route] += 1
    return out
