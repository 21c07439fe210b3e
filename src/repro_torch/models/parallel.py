"""Parallel context threaded through model apply functions, the
sharded-leaf helpers of the distributed quantization engine, and the
collectives of the sharded fine-tuning step.

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

The sharded model functions never let DTensor's dispatcher run an op: the
step turns a tree of DTensors into their local shards (:func:`localize`),
each tagged with its :class:`Layout` (layout, mesh, global shape), and the
model reads the tags to decide which collective a computation needs.  The
collectives are ``torch.autograd.Function`` s over a mesh axis's group
(Megatron's pairs): :func:`copy_to` (identity, all-reduce of the gradient),
:func:`reduce_from` (all-reduce, identity), :func:`gather_from` (all-gather;
the gradient reduce-scattered or sliced), :func:`scatter_to` (the rank's
slice, all-gather of the gradient) and :func:`reduce_scatter` (reduce-
scatter, all-gather of the gradient), each counted in :data:`ALLREDUCE_STATS`,
:data:`GATHER_STATS` or :data:`REDUCE_SCATTER_STATS`; :func:`rank_part` is
a replicated tensor used on the rank's part (``copy_to``, then a slice);
:func:`combine_softmax` joins the ranks' partial softmaxes of the
sequence-sharded decode (two counted all-reduces).
Over a group of one rank each is the identity.  Under gloo a 16-bit float
payload travels as f32, a CUDA all-gather through the host, and a
reduce-scatter as an all-reduce and the rank's slice (transports, not
fallbacks).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

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


def data_axis_tuple(pctx: PContext) -> tuple:
    """The data axes of ``pctx`` that its mesh has (the twin's
    ``PContext.data_axis_tuple``, without the absent ones)."""
    da = ((pctx.data_axes,) if isinstance(pctx.data_axes, str)
          else tuple(pctx.data_axes))
    names = getattr(pctx.mesh, "mesh_dim_names", None) or ()
    return tuple(a for a in da if a in names)


# ---------------------------------------------------------------------------
# Mesh axes and the one collective of the quantization engine.
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str = "model") -> int:
    """Size of ``axis`` of ``mesh``; 1 without a mesh or that axis."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def entry_axes(ax) -> tuple:
    """The mesh axes of one layout entry: None, an axis name, or a tuple
    of names (the dim split over them in order, the first outermost)."""
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def entry_size(mesh, ax) -> int:
    """The shards of a dim under layout entry ``ax``."""
    n = 1
    for a in entry_axes(ax):
        n *= axis_size(mesh, a)
    return n


def axis_group(mesh, axis: str = "model"):
    """The process group of ``axis``."""
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str = "model") -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


# collectives issued in this process: their number and payload bytes (the
# bytes that travel: a 16-bit float as f32 under gloo); chip_smoke.py reads
# them
ALLREDUCE_STATS = {"calls": 0, "bytes": 0}
GATHER_STATS = {"calls": 0, "bytes": 0}
REDUCE_SCATTER_STATS = {"calls": 0, "bytes": 0}


def reset_allreduce_stats() -> None:
    ALLREDUCE_STATS.update(calls=0, bytes=0)


def reset_collective_stats() -> None:
    for st in (ALLREDUCE_STATS, GATHER_STATS, REDUCE_SCATTER_STATS):
        st.update(calls=0, bytes=0)


def collective_stats() -> dict:
    return {"all_reduce": dict(ALLREDUCE_STATS),
            "all_gather": dict(GATHER_STATS),
            "reduce_scatter": dict(REDUCE_SCATTER_STATS)}


def _count(stats: dict, x: Tensor) -> None:
    stats["calls"] += 1
    stats["bytes"] += x.numel() * x.element_size()


def _wire(x: Tensor, group) -> Tensor:
    """The payload that travels for ``x``: f32 for a 16-bit float under
    gloo (its reductions are not relied on for them), ``x`` otherwise."""
    if x.dtype in (torch.bfloat16, torch.float16) and \
            dist.get_backend(group) == "gloo":
        return x.float()
    return x


def all_reduce_sum(x: Tensor, group, op=None) -> Tensor:
    """Reduce ``x`` over ``group`` in place (one collective; a sum unless
    ``op``) and return it; ``group=None`` is the identity (the unsharded
    path)."""
    if group is None:
        return x
    w = _wire(x, group)
    dist.all_reduce(w, op=op or dist.ReduceOp.SUM, group=group)
    _count(ALLREDUCE_STATS, w)
    if w is not x:
        x.copy_(w)
    return x


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def combine_softmax(out: Tensor, lse: Tensor, group) -> Tensor:
    """A softmax over keys split among the ranks of ``group``, from each
    rank's partial: ``out`` (..., d) its rows normalised over the rank's
    keys, ``lse`` (...) f32 their log-sum-exp (-inf where the rank holds no
    valid key).  ``M`` = the ranks' max of ``lse`` (one MAX all-reduce),
    ``w = exp(lse - M)``, and the result ``sum_r w out / sum_r w`` in f32
    (one SUM all-reduce of ``w out`` and ``w`` packed together).  Some
    rank must hold a valid key of every row, so that ``M`` is finite.
    Over one rank: ``out`` in f32."""
    if group_size(group) == 1:
        return out.float()
    lse = lse.float()
    m = all_reduce_sum(lse.clone(), group, op=dist.ReduceOp.MAX)
    w = torch.exp(lse - m)
    n = out.numel()
    packed = torch.cat([(w[..., None] * out.float()).reshape(-1),
                        w.reshape(-1)])
    all_reduce_sum(packed, group)
    return packed[:n].view(out.shape) / packed[n:].view(w.shape)[..., None]


def _gather_raw(x: Tensor, group, dim: int) -> Tensor:
    return _gather_local(x, dim % x.dim(), group)


def _reduce_scatter_raw(x: Tensor, group, dim: int) -> Tensor:
    """Sum ``x`` over ``group`` and keep this rank's equal slice along
    ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {n} ranks")
    step = x.shape[dim] // n
    if dist.get_backend(group) == "gloo":
        # gloo: an all-reduce and the rank's slice
        w = _wire(x, group).clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
        _count(REDUCE_SCATTER_STATS, w)
        return w.narrow(dim, r * step, step).to(x.dtype).contiguous()
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((step,) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    _count(REDUCE_SCATTER_STATS, xt)
    return out.movedim(0, dim).contiguous()


def _own_slice(x: Tensor, group, dim: int) -> Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        return _gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return (_reduce_scatter_raw(g.contiguous(), ctx.group, ctx.dim),
                    None, None, None)
        return _own_slice(g, ctx.group, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g.contiguous(), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to(x: Tensor, group) -> Tensor:
    """Identity forward, all-reduce of the gradient over ``group``: the
    input of a computation sharded over ``group`` (a column-sharded
    linear's input, a replicated leaf used on a shard)."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: Tensor, group) -> Tensor:
    """All-reduce (sum) forward, identity backward: the partial sums of a
    row-sharded linear, or of the ranks' experts."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def rank_part(x: Tensor, group, dim: int, start: int, length: int
              ) -> Tensor:
    """A replicated ``x`` used on the rank's part, ``length`` entries from
    ``start`` along ``dim``: :func:`copy_to` first, so that its gradient,
    each rank's from its own part, is summed over ``group``."""
    return copy_to(x, group).narrow(dim, start, length)


def gather_from(x: Tensor, group, dim: int, *,
                reduce_grad: bool) -> Tensor:
    """All-gather of equal shards along ``dim``.  The gradient is
    reduce-scattered when what follows differs from rank to rank
    (``reduce_grad``), else (the same computation on every rank) each rank
    keeps its slice."""
    if group_size(group) == 1:
        return x
    return _GatherFrom.apply(x, group, dim, reduce_grad)


def scatter_to(x: Tensor, group, dim: int) -> Tensor:
    """The rank's equal slice of a replicated ``x`` along ``dim``; the
    gradient is all-gathered."""
    return x if group_size(group) == 1 else _ScatterTo.apply(x, group, dim)


def reduce_scatter(x: Tensor, group, dim: int) -> Tensor:
    """Sum of the ranks' partial ``x``, the rank's slice along ``dim``;
    the gradient is all-gathered (a row-sharded linear's output under
    sequence parallelism)."""
    if group_size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group, dim)


# the dims along which row-sharded linears reduce-scatter their partial
# sums (``row_output``); None: an all-reduce
_row_out: list = []


@contextlib.contextmanager
def row_output(dim: int | None) -> Iterator[None]:
    """Inside, a row-sharded linear reduce-scatters its partial sums along
    ``dim`` instead of all-reducing them (``dim=None``: no change)."""
    _row_out.append(dim)
    try:
        yield
    finally:
        _row_out.pop()


def row_scatter_dim() -> int | None:
    return _row_out[-1] if _row_out else None


def finish_row(y: Tensor, group) -> Tensor:
    """The collective after a row-sharded linear's partial sums: the
    reduce-scatter of :func:`row_output`, else the all-reduce."""
    dim = _row_out[-1] if _row_out else None
    if dim is not None:
        return reduce_scatter(y, group, dim)
    return reduce_from(y, group)


# ---------------------------------------------------------------------------
# Layout tags: the local shards the sharded model computes on.
# ---------------------------------------------------------------------------

_TAG = "_repro_layout"


@dataclasses.dataclass(frozen=True)
class Layout:
    """A local shard's place: its ``spec`` (one mesh axis name or None a
    dim), the ``mesh`` and the full tensor's ``shape``."""
    spec: tuple
    mesh: Any
    shape: tuple

    def dim_of(self, axis: str = "model") -> int | None:
        """The dim sharded over ``axis`` (None: replicated over it or the
        axis has one rank)."""
        if axis_size(self.mesh, axis) == 1:
            return None
        for d, ax in enumerate(self.spec):
            if axis in entry_axes(ax):
                return d
        return None

    def drop_lead(self) -> "Layout":
        return Layout(self.spec[1:], self.mesh, self.shape[1:])


def layout_of(t) -> Layout | None:
    return getattr(t, _TAG, None)


def tag(t: Tensor, layout: Layout | None) -> Tensor:
    if layout is not None:
        setattr(t, _TAG, layout)
    return t


def spec_of_placements(pl, mesh, ndim: int) -> tuple:
    """The layout tuple of DTensor placements ``pl`` on ``mesh`` (a dim
    sharded over several mesh dims gets the tuple of their names)."""
    spec: list = [None] * ndim
    for name, p in zip(mesh.mesh_dim_names, pl):
        if p.is_shard():
            cur = spec[p.dim]
            spec[p.dim] = name if cur is None else entry_axes(cur) + (name,)
    return tuple(spec)


def localize(tree):
    """``tree`` with every DTensor leaf replaced by its local shard tagged
    with its :class:`Layout` (no communication); other leaves are kept."""
    if isinstance(tree, dict):
        return {k: localize(v) for k, v in tree.items()}
    if not is_sharded(tree):
        return tree
    lay = Layout(spec_of_placements(tree.placements, tree.device_mesh,
                                    tree.dim()),
                 tree.device_mesh, tuple(tree.shape))
    return tag(tree.to_local(), lay)


def delocalize(tree, like):
    """Tagged local shards back to DTensors of their layouts (``like``: the
    tree whose tags to use where a leaf carries none)."""
    if isinstance(tree, dict):
        return {k: delocalize(v, like[k]) for k, v in tree.items()}
    lay = layout_of(tree) or layout_of(like)
    if lay is None:
        return tree
    return distribute_local(tree, lay.spec, lay.mesh)


def select_layer(t: Tensor, i: int) -> Tensor:
    """``t[i]``, keeping its tag one dim further in."""
    lay = layout_of(t)
    return tag(t[i], None if lay is None else lay.drop_lead())


def model_sharded(t) -> bool:
    """Whether the tagged shard ``t`` is one of several over "model"."""
    lay = layout_of(t)
    return lay is not None and lay.dim_of("model") is not None


def model_group(tree):
    """The model axis's group of the first leaf of ``tree`` (a nested dict
    of tagged shards) sharded over it, else None."""
    if isinstance(tree, dict):
        for v in tree.values():
            g = model_group(v)
            if g is not None:
                return g
        return None
    if model_sharded(tree):
        return axis_group(layout_of(tree).mesh, "model")
    return None


# ---------------------------------------------------------------------------
# Layouts, sharded leaves and the gather.
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of layout ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim named at tensor dim ``d`` (alone or in a tuple),
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec) if name in entry_axes(ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_slice(full: Tensor, spec: tuple, mesh) -> Tensor:
    """This rank's block of a full tensor under layout ``spec`` (even
    shards: the planner only shards a dim the axis divides)."""
    out = full
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        k, r = 1, 0
        for a in entry_axes(ax):         # the first axis outermost
            n = axis_size(mesh, a)
            k, r = k * n, r * n + axis_rank(mesh, a)
        step = full.shape[d] // k
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
    goes through the host (gloo's CUDA all-gather is not relied on; its
    all-reduce and broadcast are what the engine uses on the card), and a
    16-bit float travels as f32 (:func:`_wire`), exactly."""
    dev, dtype = local.device, local.dtype
    x = _wire(local.contiguous(), group)
    _count(GATHER_STATS, x)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim).to(device=dev, dtype=dtype)


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
