"""Param-path -> layout rules.

Twin of ``repro.launch.shardings``.  A layout is
the JAX twin's PartitionSpec as a tuple (one mesh axis name or ``None`` a
tensor dim); :class:`NamedSharding` pairs it with a ``DeviceMesh`` and
gives its DTensor placements (``models.parallel.placements``).

Orientation of every linear in the zoo:
    col  -- output dim sharded over "model"   (q/k/v, gate/up, z/x_proj, head)
    row  -- input  dim sharded over "model"   (o, down, out_proj)
    rep  -- replicated                        (bc/dt_proj, router, norms)
MoE expert stacks shard the EXPERT dim over "model".  Quantized leaves
(qcodes/scales/zeros/absmax) follow their weight's orientation; LoRA splits
so that the sharded side matches the base ("col": lora_b output-sharded;
"row": lora_a input-sharded).

The distributed quantization engine gives its bucket outputs
column-sharded over "model" (``repro_torch.core.batched.bucket_out_specs``,
re-exported as :func:`quant_bucket_specs`): "col"-oriented layers can be
used in place, "row"/"rep" layers are re-laid out against
:func:`param_specs` at load time (``checkpoint.restore_tree(shardings=)``,
:meth:`NamedSharding.distribute`).

A mesh here is a ``DeviceMesh`` or anything with ``mesh_dim_names`` (or
``axis_names``) and ``shape`` (a tuple in the names' order, or a dict by
name): the layout rules need no devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import parallel
from repro_torch.utils import set_path, tree_paths

COL = {"q", "k", "v", "gate", "up", "z_proj", "x_proj", "head"}
ROW = {"o", "down", "out_proj"}
REP = {"bc_proj", "dt_proj", "router"}

# leaf kind -> (layout for col, row, rep); dims are the rule's trailing dims
_LEAF_RULES = {
    "w":      ((None, "model"), ("model", None), (None, None)),
    "qcodes": ((None, "model"), ("model", None), (None, None)),
    "scales": ((None, "model"), ("model", None), (None, None)),
    "zeros":  ((None, "model"), ("model", None), (None, None)),
    "absmax": ((None, "model"), ("model", None), (None, None)),
    "lora_a": ((None, None),    ("model", None), (None, None)),
    "lora_b": (("model", None), (None, None),    (None, None)),
    "b":      (("model",),      (None,),         (None,)),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: the counterpart of ``jax.sharding.
    NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return parallel.placements(self.spec, self.mesh)

    def distribute(self, full):
        """This rank's block of the full tensor ``full`` as a DTensor."""
        return parallel.distribute_local(
            parallel.local_slice(full, self.spec, self.mesh).contiguous(),
            self.spec, self.mesh)


def _orientation(path: str) -> str:
    segs = path.split(".")
    for base in reversed(segs[:-1]):
        if base in COL:
            return "col"
        if base in ROW:
            return "row"
        if base in REP:
            return "rep"
        # hybrid site_lora keys like "mlp_down"
        if "_" in base:
            tail = base.split("_")[-1]
            if tail in COL:
                return "col"
            if tail in ROW:
                return "row"
    return "rep"


def spec_for_path(path: str, ndim: int) -> tuple:
    """The layout of the leaf at ``path`` with ``ndim`` dims."""
    leaf = path.split(".")[-1]
    if path.endswith("embed.w"):
        return ("model", None)
    if leaf in ("conv_x", "conv_x_b"):
        return (None,) * (ndim - 1) + ("model",) if ndim >= 1 else ()
    if leaf not in _LEAF_RULES:
        return (None,) * ndim
    rules = _LEAF_RULES[leaf]
    tail = {"col": rules[0], "row": rules[1],
            "rep": rules[2]}[_orientation(path)]
    if ".moe." in f".{path}." and "router" not in path:
        # expert stack: base rank 1 (E) + the rule's; the expert dim over
        # "model", extra leading dims (a layer stack) unsharded
        pad = ndim - (1 + len(tail))
        if pad < 0:
            return (None,) * ndim
        return (None,) * pad + ("model",) + (None,) * len(tail)
    pad = ndim - len(tail)
    if pad < 0:          # e.g. a scalar bias on a rule expecting 2 dims
        return (None,) * ndim
    return (None,) * pad + tuple(tail)


def _axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)


def _axis_len(mesh, axis: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[axis])
    return int(shape[_axis_names(mesh).index(axis)])


def param_specs(shapes_tree, mesh=None) -> dict:
    """Tree of layouts matching a tree of tensors (or meta tensors, or
    DTensors: their full shapes).  With ``mesh``, an axis a dim's size
    does not divide is dropped (the dim replicated): e.g. group-scale rows
    ``m / 64`` of a row-parallel layer that the axis does not divide."""
    out: dict = {}
    for path, leaf in tree_paths(shapes_tree).items():
        nd = len(leaf.shape) if hasattr(leaf, "shape") else 0
        sp = spec_for_path(path, nd)
        if len(sp) != nd:          # 0-size placeholders, scalars, etc.
            sp = (None,) * nd
        elif mesh is not None:
            sp = tuple(ax if ax is None or size % _axis_len(mesh, ax) == 0
                       else None for size, ax in zip(leaf.shape, sp))
        set_path(out, path, sp)
    return out


def _divisible(n: int, mesh, axis: str) -> bool:
    return axis in _axis_names(mesh) and n % _axis_len(mesh, axis) == 0


def _bdiv(b: int, mesh, dp) -> bool:
    axes = (dp,) if isinstance(dp, str) else tuple(dp)
    total = 1
    for ax in axes:
        if ax not in _axis_names(mesh):
            return False
        total *= _axis_len(mesh, ax)
    return b % total == 0


def cache_specs(cfg, cache_tree, mesh, data_axes) -> dict:
    """Decode-cache layouts.  KV caches ``(L, B, T, Hkv, hd)``: the batch
    over the data axes; the heads over "model" where it divides them, else
    the sequence (decoded by a distributed softmax over the ranks' keys,
    ``models.attention._decode_seq_sharded``).  SSM states shard heads over "model", conv
    windows their channels; batch-1 caches leave the data axes unused.  A
    layout names one axis a dim; several data axes become the tuple's
    entry as the twin's ``P((pod, data), ...)`` does."""
    dp = data_axes
    specs: dict = {}
    for path, leaf in tree_paths(cache_tree).items():
        shape = tuple(leaf.shape)
        if path in ("k", "v") or path.endswith(".k") or path.endswith(".v"):
            L, B, T, H, hd = shape
            bspec = dp if _bdiv(B, mesh, dp) else None
            if _divisible(H, mesh, "model"):
                specs[path] = (None, bspec, None, "model", None)
            elif _divisible(T, mesh, "model"):
                specs[path] = (None, bspec, "model", None, None)
            else:
                specs[path] = (None, bspec, None, None, None)
        elif path.endswith("state"):
            L, B, H, pd, n = shape
            bspec = dp if _bdiv(B, mesh, dp) else None
            hspec = "model" if _divisible(H, mesh, "model") else None
            specs[path] = (None, bspec, hspec, None, None)
        elif path.endswith("conv_x"):
            L, B, K, C = shape
            bspec = dp if _bdiv(B, mesh, dp) else None
            cspec = "model" if _divisible(C, mesh, "model") else None
            specs[path] = (None, bspec, None, cspec)
        elif path.endswith("conv_bc"):
            L, B, K, C = shape
            bspec = dp if _bdiv(B, mesh, dp) else None
            specs[path] = (None, bspec, None, None)
        elif path.endswith("enc_out"):
            B, S, D = shape
            bspec = dp if _bdiv(B, mesh, dp) else None
            specs[path] = (bspec, None, None)
        else:  # idx scalars
            specs[path] = (None,) * len(shape)
    out: dict = {}
    for pth, sp in specs.items():
        set_path(out, pth, sp)
    return out


def to_named(specs_tree, mesh):
    """A tree of layouts as :class:`NamedSharding` s on ``mesh``."""
    if isinstance(specs_tree, dict):
        return {k: to_named(v, mesh) for k, v in specs_tree.items()}
    return NamedSharding(mesh, tuple(specs_tree))


def constrain(x, mesh, spec: tuple):
    """``x`` re-laid out to ``spec`` on ``mesh``: a DTensor gathered whole
    first, then every tensor given the rank's block of it (a DTensor of
    ``spec``).  The identity without a mesh."""
    if mesh is None:
        return x
    return NamedSharding(mesh, tuple(spec)).distribute(
        parallel.full_tensor(x))


def quant_bucket_specs(method: str, axis: str = "model") -> dict:
    """Layouts of one quantization bucket's stacked leaves (leading dim
    ``L``): ``repro_torch.core.batched.bucket_out_specs``."""
    from repro_torch.core.batched import bucket_out_specs
    return bucket_out_specs(method, axis)


def quant_task_specs(method: str, axis: str | None = "model",
                     lead: int = 0) -> dict:
    """Layouts of ONE quantized layer's leaves, the layout the bucket
    manifest records: ``repro_torch.core.batched.task_leaf_specs``."""
    from repro_torch.core.batched import task_leaf_specs
    return task_leaf_specs(method, axis, lead=lead)


def quant_site_specs(sites: dict, shapes_tree=None, mesh=None,
                     axis: str = "model", cost_model=None) -> dict:
    """Engine layouts of every resolved site of a recipe
    (``{lin_path: {leaf: layout}}``, skipped sites omitted).  ``sites`` is
    ``QuantRecipe.resolve``'s dict.  With ``mesh`` and a ``shapes_tree``
    holding each site's ``w`` (tensors or meta tensors), a site is sharded
    by the planner's gate (``batched.bucket_shards``); with a
    ``cost_model`` too, sites are grouped as the planner's buckets and the
    predicted-time decision replaces the gate, as
    ``plan_buckets(cost_model=)`` decides."""
    from repro_torch.core.batched import (bucket_axis_size, bucket_shards,
                                          task_leaf_specs)
    from repro_torch.utils import get_path
    out = {}
    if cost_model is not None and mesh is not None and \
            shapes_tree is not None:
        from repro_torch.core.costmodel import CostModel
        cm = CostModel.coerce(cost_model)
        groups: dict = {}          # planner bucket key -> member paths
        for path, site in sites.items():
            if site.skip:
                continue
            w = get_path(shapes_tree, path)["w"]
            key = (site.method, int(w.shape[-2]), int(w.shape[-1]),
                   site.qspec.rank)
            groups.setdefault(key, []).append(path)
        k = bucket_axis_size(mesh, axis)
        for (method, m, n, rank), paths in groups.items():
            _, shards = cm.decide_geometry(method, m=m, n=n,
                                           L=len(paths), k=k, rank=rank)
            ax = axis if shards > 1 else None
            for p in paths:
                out[p] = task_leaf_specs(method, ax)
        return out
    for path, site in sites.items():
        if site.skip:
            continue
        ax = None
        if mesh is not None and shapes_tree is not None:
            n = int(get_path(shapes_tree, path)["w"].shape[-1])
            if bucket_shards(n, site.method, mesh, axis) > 1:
                ax = axis
        out[path] = task_leaf_specs(site.method, ax)
    return out
