"""Meshes of the distributed quantization engine, and the launcher of its
ranks.

Twin of ``repro.launch.mesh``.  A JAX mesh lays one process's devices out
on named axes; here every mesh position is a rank of its own (SPMD), and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group, which must be initialized first
(``torch.distributed.init_process_group`` with an explicit address, rank
and world size, or :func:`spawn_ranks`).  Its backend is the caller's
choice and is checked here, not worked around:

* NCCL, one rank a card: what a host with several cards runs.  More ranks
  than cards raises (NCCL refuses two ranks on one device), as does NCCL
  for CPU tensors.
* gloo: CPU tensors, and CUDA tensors for ``all_reduce`` and ``broadcast``
  (the engine's collectives), so several ranks can share one card.  The
  gather of sharded leaves goes through the host under gloo
  (:func:`repro_torch.models.parallel.full_tensor`).
* fake (torch's ``FakeProcessGroup``, one process standing in for rank r
  of the whole group): only for the dry run (``launch/dryrun.py``), on
  the meta device or the CPU, where no collective moves data.  It is no
  fallback: a CUDA mesh over it raises.

:func:`make_production_mesh` is the (16, 16) / (2, 16, 16) mesh of the
twin over the default group: NCCL on a pod, the fake group in the dry run
(:func:`init_fake_group`).
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.parallel import PContext


def _device_type(device_type: str | None) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device_type='cpu' for a mesh "
                "of CPU ranks")
        return "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but CUDA is not available")
    return device_type


def _check_backend(device_type: str, n_ranks: int) -> None:
    """Raise when the default group's backend cannot run on
    ``device_type`` with ``n_ranks`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialized: call torch.distributed."
            "init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) first (or run under launch.mesh.spawn_ranks)")
    backend = dist.get_backend()
    if backend == "nccl":
        if device_type != "cuda":
            raise RuntimeError("the nccl backend runs CUDA tensors only; "
                               "use gloo for a CPU mesh")
        if n_ranks > torch.cuda.device_count():
            raise RuntimeError(
                f"nccl with {n_ranks} ranks on {torch.cuda.device_count()} "
                "card(s): NCCL refuses two ranks on one device; use gloo "
                "to share a card")
    elif backend == "fake":
        if device_type not in ("cpu", "meta"):
            raise RuntimeError(
                "the fake backend (the dry run's stand-in for a pod) moves "
                f"no data: it takes a meta or cpu mesh, not {device_type}")
    elif backend != "gloo":
        raise RuntimeError(f"unsupported backend {backend!r} for a "
                           f"{device_type} mesh (nccl, gloo, or fake for "
                           "the dry run)")


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    n_pod: int | None = None, *,
                    device_type: str | None = None):
    """A ``("data", "model")`` mesh (``("pod", "data", "model")`` with
    ``n_pod``) over the ranks of the default group, whose size must be the
    mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    dt = _device_type(device_type)
    shape = (n_pod, n_data, n_model) if n_pod else (n_data, n_model)
    names = ("pod", "data", "model") if n_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _check_backend(dt, n)
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks; "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(dt, shape, mesh_dim_names=names)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False,
                         device_type: str | None = None):
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) with "pod" first, over the default group (NCCL on a pod; torch's
    fake group in the dry run, :func:`init_fake_group`, with
    ``device_type="cpu"``), whose size must be 256 or 512.
    ``device_type`` defaults to CUDA."""
    shape, _ = PRODUCTION_SHAPES[bool(multi_pod)]
    if len(shape) == 3:
        return make_local_mesh(shape[1], shape[2], shape[0],
                               device_type=device_type)
    return make_local_mesh(*shape, device_type=device_type)


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Make the default group torch's fake one of ``world_size`` ranks,
    this process being ``rank`` (the dry run: every collective returns at
    once and moves nothing).  An initialized fake group of another size or
    rank is replaced; any other initialized group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} group is initialized; the dry run "
                "needs the fake one")
        if dist.get_world_size() == world_size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_model_mesh(n_model: int | None = None, *,
                    device_type: str | None = None):
    """1-D ``("model",)`` mesh for the distributed quantization engine:
    quantization is pure model parallelism (column shards of each weight),
    so every rank sits on the model axis.  ``n_model`` defaults to the
    world size and must equal it.  ``device_type`` defaults to CUDA
    (raising without it)."""
    from torch.distributed.device_mesh import init_device_mesh
    dt = _device_type(device_type)
    _check_backend(dt, dist.get_world_size() if dist.is_initialized() else 0)
    n = n_model or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a model mesh of {n} needs {n} ranks; the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(dt, (n,), mesh_dim_names=("model",))


def data_axes_of(mesh) -> tuple:
    return tuple(ax for ax in mesh.mesh_dim_names if ax in ("pod", "data"))


def pcontext_for(mesh) -> PContext:
    da = data_axes_of(mesh)
    return PContext(mesh=mesh, data_axes=da if len(da) > 1 else da[0],
                    model_axis="model")


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, backend: str, store_path: str,
               device: str, threads: int, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(threads)
    if device == "cuda":
        # one rank a card under nccl; every rank on card 0 under gloo
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
        dist.barrier()  # reprolint: disable=COLLECTIVE (ranks leave together; outside any step)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], n_ranks: int, *, backend: str,
                device: str, args: tuple = (), threads: int | None = None,
                store_dir: str | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``n_ranks`` fresh processes (start
    method ``spawn``: safe after the parent touched CUDA), each in the
    process group ``backend`` through a ``FileStore`` under ``store_dir``
    (a new temporary directory when None).  On CUDA the parent builds the
    kernels first (the ranks load that build, never compile) and empties
    its allocator's cache.  ``threads``: each rank's intra-op threads
    (default: the parent's over ``n_ranks``).  Raises if any rank fails:
    ``torch.multiprocessing.spawn`` stops the others and re-raises the
    failing rank's error."""
    import torch.multiprocessing as mp
    if backend == "nccl" and n_ranks > max(torch.cuda.device_count(), 0):
        raise RuntimeError(f"nccl with {n_ranks} ranks on "
                           f"{torch.cuda.device_count()} card(s); use gloo")
    if device == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    threads = threads or max(1, torch.get_num_threads() // n_ranks)
    own = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_torch_store_")
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store.{os.getpid()}")
    if os.path.exists(store_path):
        os.unlink(store_path)
    try:
        mp.spawn(_rank_main, nprocs=n_ranks, join=True,
                 args=(n_ranks, backend, store_path, device, threads, fn,
                       args))
    finally:
        if os.path.exists(store_path):
            os.unlink(store_path)
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
