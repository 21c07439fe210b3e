"""The dry run: one rank's step of every (arch x shape cell x mesh) on the
meta device.  Twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --cell train_4k [--multi-pod] [--bits 4] [--depth N] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep [--depth 1]

For each cell this:
  1. makes the default process group torch's fake one of 256 ranks (512
     with ``--multi-pod``), this process standing in for rank ``--rank``
     (0), and builds the production mesh over it (16 x 16, or 2 x 16 x 16;
     ``launch.mesh.make_production_mesh``);
  2. builds the cell's abstract state (meta tensors: nothing allocated)
     and gives the rank its shards as DTensors by ``param_specs`` /
     ``state_pspecs`` / ``cache_specs`` / ``batch_pspecs``;
  3. runs the rank's train, prefill or decode step eagerly on them under
     the span ``dryrun.lower``: success shows the layouts compose on that
     mesh (every collective of the step is issued on the fake group, which
     moves nothing);
  4. writes a JSON record under the twin's keys where they mean the same:
     ``memory.argument_bytes`` and ``memory.output_bytes`` (the rank's
     local shards of the step's inputs and outputs), ``memory.alias_bytes``
     (outputs that are inputs' storage: the decode cache written in place,
     the frozen base), ``memory.peak_bytes`` (the peak of the storages the
     step allocates, alive at once, counted by a ``TorchDispatchMode``; it
     excludes the arguments, and XLA's scratch ``temp_bytes`` has no
     counterpart), ``collectives`` (calls and bytes of each kind, from
     ``models.parallel.collective_stats``), ``budget`` and, for a cell
     ``cell_applicable`` refuses, the twin's skip record.  XLA's
     ``cost_analysis`` has no counterpart here: the record has no ``cost``.

The dry run runs on the host and allocates nothing; it never touches a
card.  ``--unroll`` is recorded only (the port's layers are always a
Python loop); ``--kv8`` gives the cache ``torch.float8_e4m3fn`` K/V, which
the plain attention reads (the kernels take bf16 or f32).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import parallel


class PeakBytes(TorchDispatchMode):
    """Inside: the bytes of the storages created by the ops run, alive at
    once (``live``) and at most (``peak``).  A storage counts from the op
    whose output first holds it (one that shares an input's storage, a
    view or an in-place op, is not new) until no tensor holds it."""

    def __init__(self):
        super().__init__()
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.live: dict[int, tuple] = {}
        self.bytes = 0
        self.peak = 0

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.bytes -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._sweep()
        seen = {t.untyped_storage()._cdata
                for t in pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            self.live[key] = (self._ref(st), st.nbytes())
            self.bytes += st.nbytes()
        self.peak = max(self.peak, self.bytes)
        return out


def _local_shape(shape, spec, mesh) -> tuple:
    return tuple(n // parallel.entry_size(mesh, ax)
                 for n, ax in zip(shape, spec))


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of the rank's shards of a tree of (meta) tensors laid out by
    the matching tree of layouts ``specs``."""
    if isinstance(tree, dict):
        return sum(local_bytes(v, specs[k], mesh) for k, v in tree.items())
    n = 1
    for d in _local_shape(tree.shape, tuple(specs), mesh):
        n *= d
    return n * tree.element_size()


def _distribute(tree, specs, mesh):
    """The rank's shards of a tree of meta tensors as meta DTensors."""
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    spec = tuple(specs)
    if tree.dim() == 0:
        return torch.empty((), dtype=tree.dtype, device="meta")
    local = torch.empty(_local_shape(tree.shape, spec, mesh),
                        dtype=tree.dtype, device="meta")
    return parallel.distribute_local(local, spec, mesh)


def _out_bytes(out, arg_storages: set) -> tuple[int, int]:
    """(bytes, aliased bytes) of a step's outputs: each storage once, its
    local shard where a DTensor."""
    seen: set = set()
    total = alias = 0
    for t in pytree.tree_leaves(out):
        if not isinstance(t, torch.Tensor):
            continue
        st = parallel.local_of(t).untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        total += st.nbytes()
        if st._cdata in arg_storages:
            alias += st.nbytes()
    return total, alias


def _storages(tree) -> set:
    return {parallel.local_of(t).untyped_storage()._cdata
            for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)}


def _replicated(specs):
    if isinstance(specs, dict):
        return {k: _replicated(v) for k, v in specs.items()}
    return (None,) * len(specs)


def _mesh_for(multi_pod: bool, rank: int, mesh_shape):
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, init_fake_group,
                                         make_local_mesh,
                                         make_production_mesh)
    if mesh_shape is None:
        shape = PRODUCTION_SHAPES[bool(multi_pod)][0]
    else:
        shape = tuple(mesh_shape)
    n = 1
    for s in shape:
        n *= s
    init_fake_group(n, rank)
    if mesh_shape is None:
        return make_production_mesh(multi_pod, device_type="cpu")
    return make_local_mesh(*shape, device_type="cpu")


def lower_cell(arch: str, cell: str, *, multi_pod: bool = False,
               bits: int = 4, depth: int | None = None,
               unroll: bool = False, remat: str = "full",
               moe_dense: bool = False, verbose: bool = True,
               loss_chunk: int = 0, attn_chunk: int = 0,
               seq_shard: bool = False, dp_only: bool = False,
               prefill_last: bool = False, microbatch: int = 1,
               ssm_chunk: int = 0, kv8: bool = False,
               recipe_path: str | None = None, budget_mb: float = 0.0,
               rank: int = 0, mesh_shape: tuple | None = None,
               smoke: bool = False, group_size: int = 64) -> dict:
    """Run rank ``rank``'s step of one cell on the meta device and return
    its record (module docstring).  Beyond the twin's arguments:
    ``mesh_shape`` a (data, model) mesh over a fake group of its size
    instead of the production mesh, ``smoke`` the arch's smoke config,
    ``group_size`` the quantization group (64 as the twin's)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import pcontext_for
    from repro_torch.launch.shardings import cache_specs, param_specs
    from repro_torch.launch.steps import (SHAPE_CELLS, abstract_cache,
                                          abstract_params, abstract_state,
                                          batch_pspecs, batch_specs,
                                          cell_applicable, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          state_pspecs)
    from repro_torch.models.modules import QSpec
    from repro_torch.models.parallel import PContext
    from repro_torch.optim import OptConfig

    get = get_smoke_config if smoke else get_config
    qspec = QSpec(bits=bits, group_size=group_size, rank=64)
    overrides: dict = {"quant": qspec, "remat": remat}
    if depth is not None:
        overrides["n_layers"] = depth
        if get(arch).family == "encdec":
            overrides["n_enc_layers"] = depth
    if moe_dense:
        overrides["capacity_factor"] = 2.0
    if loss_chunk:
        overrides["loss_chunk"] = loss_chunk
    if attn_chunk:
        overrides["attn_chunk"] = attn_chunk
    if seq_shard:
        overrides["seq_shard"] = True
    if ssm_chunk:
        overrides["ssm_chunk"] = ssm_chunk
    cfg = get(arch, **overrides)

    recipe = None
    if recipe_path:
        from repro_torch.core.recipe import load_plan
        recipe = load_plan(recipe_path)
    budget = None
    if budget_mb:
        from repro_torch.core.pipeline import recipe_plan_bytes
        from repro_torch.core.recipe import QuantRecipe
        plan = recipe or QuantRecipe.single("cloq", qspec)
        plan_bytes = recipe_plan_bytes(cfg, plan)
        budget = {"budget_bytes": int(budget_mb * 2**20),
                  "plan_bytes": plan_bytes,
                  "fits": plan_bytes <= int(budget_mb * 2**20)}
        if verbose and not budget["fits"]:
            print(f"[budget] plan needs {plan_bytes} B > budget "
                  f"{budget['budget_bytes']} B", flush=True)

    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "cell": cell, "skipped": True, "reason": why,
                "budget": budget}

    mesh = _mesh_for(multi_pod, rank, mesh_shape)
    pctx = pcontext_for(mesh)
    if dp_only:
        if cfg.family == "moe":
            raise ValueError("dp_only is not defined for expert-parallel "
                             "archs")
        pctx = PContext(mesh=mesh, data_axes=tuple(mesh.mesh_dim_names),
                        model_axis="model")
    kind = SHAPE_CELLS[cell]["kind"]
    t0 = time.time()
    if kind == "train":
        ocfg = OptConfig(total_steps=1000, microbatch=microbatch)
        shapes = abstract_state(cfg, ocfg, recipe)
        specs = state_pspecs(shapes, mesh)
        batch = batch_specs(cfg, cell)
        args = (shapes, batch)
        arg_specs = (specs, batch_pspecs(cfg, cell, pctx.data_axes))
        step = make_train_step(cfg, ocfg, pctx)
    elif kind == "prefill":
        shapes = abstract_params(cfg, recipe)
        batch = batch_specs(cfg, cell)
        args = (shapes, batch)
        arg_specs = (param_specs(shapes, mesh),
                     batch_pspecs(cfg, cell, pctx.data_axes))
        step = make_prefill_step(cfg, pctx, last_only=prefill_last)
    else:
        shapes = abstract_params(cfg, recipe)
        kv_dtype = torch.float8_e4m3fn if kv8 else None
        cache = abstract_cache(cfg, cell, kv_dtype)
        B = SHAPE_CELLS[cell]["batch"]
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        args = (shapes, cache, tokens)
        arg_specs = (param_specs(shapes, mesh),
                     cache_specs(cfg, cache, mesh, pctx.data_axes),
                     (pctx.data_axes if B > 1 else None, None))
        step = make_decode_step(cfg, pctx)
    if dp_only:
        arg_specs = (_replicated(arg_specs[0]),) + arg_specs[1:]
    arg_bytes = sum(local_bytes(a, s, mesh) for a, s in zip(args, arg_specs))
    # the step's inputs: the state, params and cache as the rank's
    # DTensors; the batch and tokens global (the step takes its rows)
    sharded = 2 if kind == "decode" else 1
    inputs = [_distribute(a, s, mesh) for a, s in
              zip(args[:sharded], arg_specs[:sharded])] + list(args[sharded:])
    arg_storages = _storages(inputs)
    parallel.reset_collective_stats()
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    with grad:
        with PeakBytes() as peak:
            out = step(*inputs)
    t_run = time.time() - t0  # reprolint: disable=BENCH (meta tensors: no device work)
    out_bytes, alias = _out_bytes(out, arg_storages)
    colls = parallel.collective_stats()
    names = tuple(mesh.mesh_dim_names)
    result = {
        "arch": arch, "cell": cell,
        "mesh": "x".join(str(mesh.size(i)) for i in range(len(names))),
        "axes": list(names), "multi_pod": multi_pod, "rank": rank,
        "bits": bits, "depth": depth, "unroll": unroll, "remat": remat,
        "n_chips": mesh.size(), "recipe": recipe_path or None,
        "kv8": kv8, "seq_shard": seq_shard, "dp_only": dp_only,
        "lower_s": round(t_run, 2),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "alias_bytes": alias, "peak_bytes": peak.peak},
        "collectives": {"total_bytes": sum(c["bytes"]
                                           for c in colls.values()),
                        "per_kind": {k: c["bytes"] for k, c in colls.items()},
                        "calls": {k: c["calls"] for k, c in colls.items()},
                        "n_ops": sum(c["calls"] for c in colls.values())},
        "budget": budget,
    }
    if kind == "decode":
        result["kv_shard"] = kv_shard_record(cfg, inputs[1])
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def kv_shard_record(cfg, cache) -> dict | None:
    """A KV cache's local shard shape and which of its dims "model"
    shards (2: the sequence, decoded by the distributed softmax; 3: the
    KV heads), or None for a cache without one."""
    if "k" not in cache and "shared_kv" not in cache:
        return None
    k = cache.get("k", cache.get("shared_kv", {}).get("k"))
    lay = parallel.layout_of(parallel.localize({"k": k})["k"])
    dim = None if lay is None else lay.dim_of("model")
    return {"local": list(parallel.local_of(k).shape), "model_dim": dim,
            "sequence_sharded": dim == 2}


def sweep(out: str, bits: int, archs=None, cells=None,
          meshes=("single", "multi"), force: bool = False,
          depth: int | None = None) -> int:
    """Every (arch x cell x mesh) into ``out/<arch>.<cell>.<mesh>.json``;
    returns the failures (each recorded with its error)."""
    from repro_torch.configs import ALIASES, ARCH_IDS
    from repro_torch.launch.steps import SHAPE_CELLS
    inv = {v: k for k, v in ALIASES.items()}
    archs = archs or [inv[a] for a in ARCH_IDS]
    cells = cells or list(SHAPE_CELLS)
    os.makedirs(out, exist_ok=True)
    failures = 0
    for arch in archs:
        for cell in cells:
            for mesh_kind in meshes:
                tag = f"{arch}.{cell}.{mesh_kind}"
                path = os.path.join(out, tag + ".json")
                if os.path.exists(path) and not force:
                    print("skip (cached)", tag)
                    continue
                t0 = time.time()
                try:
                    res = lower_cell(arch, cell,
                                     multi_pod=(mesh_kind == "multi"),
                                     bits=bits, depth=depth, verbose=False)
                except Exception as e:  # record the failure, keep sweeping
                    res = {"arch": arch, "cell": cell, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = ("SKIP" if res.get("skipped")
                          else "FAIL" if res.get("error") else "ok")
                print(f"[{status}] {tag}  ({time.time() - t0:.0f}s)",
                      flush=True)
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--cell", default=None)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--depth", type=int, default=None,
                   help="override the layer count (an enc-dec model's on "
                        "both sides)")
    p.add_argument("--unroll", action="store_true",
                   help="recorded only: the port's layers are always a "
                        "Python loop")
    p.add_argument("--remat", default="full",
                   choices=["full", "dots", "tp_out", "none"])
    p.add_argument("--loss-chunk", type=int, default=0)
    p.add_argument("--attn-chunk", type=int, default=0)
    p.add_argument("--seq-shard", action="store_true")
    p.add_argument("--dp-only", action="store_true")
    p.add_argument("--prefill-last", action="store_true")
    p.add_argument("--microbatch", type=int, default=1)
    p.add_argument("--ssm-chunk", type=int, default=0)
    p.add_argument("--kv8", action="store_true")
    p.add_argument("--recipe", default="",
                   help="QuantRecipe JSON (or a bucket manifest embedding "
                        "one): the cell's per-site abstract layout")
    p.add_argument("--budget-mb", type=float, default=0.0,
                   help="check the plan's exact serialized bytes against "
                        "this budget (MiB) from abstract shapes; recorded "
                        "in the JSON")
    p.add_argument("--rank", type=int, default=0,
                   help="the rank of the fake group this process runs")
    p.add_argument("--tag", default="", help="suffix for the output file")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--trace-out", default="", metavar="FILE",
                   help="write a chrome-trace span timeline to FILE")
    p.add_argument("--metrics-out", default="", metavar="FILE",
                   help="write the metrics-registry snapshot to FILE "
                        "(defaults to results/metrics-dryrun.json when "
                        "--trace-out is set)")
    args = p.parse_args(argv)

    from repro_torch import obs
    metrics_out = args.metrics_out or (
        obs.default_metrics_path("dryrun") if args.trace_out else "")
    with obs.session(args.trace_out or None, metrics_out or None):
        return _run(args)


def _run(args) -> int:
    from repro_torch.obs import trace as obs_trace

    if args.sweep:
        archs = [args.arch] if args.arch else None
        cells = [args.cell] if args.cell else None
        return 1 if sweep(args.out, args.bits, archs, cells,
                          depth=args.depth) else 0
    if not args.arch or not args.cell:
        raise SystemExit("--arch and --cell (or --sweep)")
    with obs_trace.span("dryrun.lower", arch=str(args.arch),
                        cell=str(args.cell)):
        res = lower_cell(args.arch, args.cell, multi_pod=args.multi_pod,
                         bits=args.bits, depth=args.depth,
                         unroll=args.unroll, remat=args.remat,
                         loss_chunk=args.loss_chunk,
                         attn_chunk=args.attn_chunk,
                         seq_shard=args.seq_shard, dp_only=args.dp_only,
                         prefill_last=args.prefill_last,
                         microbatch=args.microbatch,
                         ssm_chunk=args.ssm_chunk, kv8=args.kv8,
                         recipe_path=args.recipe or None,
                         budget_mb=args.budget_mb, rank=args.rank)
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}.{args.cell}.{'multi' if args.multi_pod else 'single'}"
    if args.depth:
        tag += f".d{args.depth}{'u' if args.unroll else ''}"
    if args.remat != "full":
        tag += f".{args.remat}"
    if args.recipe:
        tag += ".recipe"
    if args.tag:
        tag += f".{args.tag}"
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", path)
    return 0 if not res.get("error") else 1


if __name__ == "__main__":
    sys.exit(main())
