"""Parallel context threaded through model apply functions, and the
sharded-leaf helpers of the distributed quantization engine.

``PContext`` keeps the signature of ``repro.models.parallel``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group (:mod:`repro_torch.launch.mesh`); every rank of it runs the same
program on its own columns (SPMD).  A layout is the JAX twin's
PartitionSpec written as a tuple, one mesh axis name (or ``None``) a tensor
dim: ``(None, "model")`` shards the last dim of a 2-D leaf over the model
axis.  A sharded leaf is a ``torch.distributed.tensor.DTensor`` holding the
rank's local shard with the ``Shard``/``Replicate`` placements of its
layout (:func:`distribute_local`); :func:`gather_tree` turns a tree of them
back into full tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PContext:
    """Mesh + axis-name bundle.  ``mesh=None`` => single-device eager path."""
    mesh: Any = None
    data_axes: Any = "data"
    model_axis: str = "model"


LOCAL = PContext()


# ---------------------------------------------------------------------------
# Mesh axes and the one collective of the quantization engine.
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str = "model") -> int:
    """Size of ``axis`` of ``mesh``; 1 without a mesh or that axis."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def axis_group(mesh, axis: str = "model"):
    """The process group of ``axis``."""
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str = "model") -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


# all-reduces issued through :func:`all_reduce_sum` in this process: their
# number and payload bytes (chip_smoke.py reads them)
ALLREDUCE_STATS = {"calls": 0, "bytes": 0}


def reset_allreduce_stats() -> None:
    ALLREDUCE_STATS.update(calls=0, bytes=0)


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """Sum ``x`` over ``group`` in place (one collective) and return it;
    ``group=None`` is the identity (the unsharded path)."""
    if group is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    ALLREDUCE_STATS["calls"] += 1
    ALLREDUCE_STATS["bytes"] += x.numel() * x.element_size()
    return x


# ---------------------------------------------------------------------------
# Layouts, sharded leaves and the gather.
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of layout ``spec`` on ``mesh``: ``Shard(d)`` on
    the mesh dim named at tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec) if ax == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_slice(full: Tensor, spec: tuple, mesh) -> Tensor:
    """This rank's block of a full tensor under layout ``spec`` (even
    shards: the planner only shards a dim the axis divides)."""
    out = full
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        k = axis_size(mesh, ax)
        step = full.shape[d] // k
        r = axis_rank(mesh, ax)
        out = out.narrow(d, r * step, step)
    return out


def distribute_local(local: Tensor, spec: tuple, mesh):
    """The rank's shard ``local`` as a DTensor of layout ``spec`` (no
    communication: every rank holds its own block)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_of(x) -> Tensor:
    """The local tensor of a DTensor (the tensor itself otherwise)."""
    return x.to_local() if is_sharded(x) else x


def stack_sharded(xs: list):
    """``torch.stack`` of same-layout leaves along a new dim 0: DTensors
    stack their local shards and keep their placements one dim further
    in."""
    if not is_sharded(xs[0]):
        return torch.stack(xs)
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in xs[0].placements]
    return DTensor.from_local(torch.stack([x.to_local() for x in xs]),
                              xs[0].device_mesh, pl, run_check=False)


def _gather_local(local: Tensor, dim: int, group) -> Tensor:
    """All-gather of equal shards along ``dim``.  Under gloo a CUDA shard
    goes through the host: gloo's CUDA all-gather is not relied on (its
    all-reduce and broadcast are what the engine uses on the card).  16-bit
    floats travel as their int16 bits."""
    dev, dtype = local.device, local.dtype
    via_host = local.is_cuda and dist.get_backend(group) == "gloo"
    x = local.contiguous()
    if dtype in (torch.bfloat16, torch.float16):
        x = x.view(torch.int16)
    if via_host:
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    if dtype in (torch.bfloat16, torch.float16):
        out = out.view(dtype)
    return out.to(dev)


def full_tensor(x):
    """The full tensor of a DTensor (a collective over every sharded mesh
    dim: every rank of the mesh must call it); anything else as it is."""
    if not is_sharded(x):
        return x
    mesh = x.device_mesh
    out = x.to_local()
    for i, p in enumerate(x.placements):
        if p.is_shard():
            out = _gather_local(out, p.dim, mesh.get_group(i))
    return out


def gather_tree(tree):
    """A nested dict (or list) with every DTensor leaf replaced by its full
    tensor (:func:`full_tensor`, dict keys in sorted order so every rank
    issues the same collectives); other leaves are kept."""
    if isinstance(tree, dict):
        return {k: gather_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return full_tensor(tree)


def tree_has_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(tree_has_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(tree_has_sharded(v) for v in tree)
    return is_sharded(tree)
