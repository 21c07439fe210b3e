"""Rank bodies of the port's distributed tests (``tests/test_torch_
distributed.py``): run under ``repro_torch.launch.mesh.spawn_ranks`` with 2
gloo ranks on the CPU.  Imports torch and ``repro_torch`` only, so a rank
does not pay for importing JAX.

``run(rank, workdir)`` reads ``workdir/inputs.pt`` (written by the test),
runs every sharded scenario on a 2-rank ``("model",)`` mesh, checks what
only a rank can see (its own blocks), gathers the rest and rank 0 writes
``workdir/outputs.pkl``: numpy arrays and plain data.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import batched as tb
from repro_torch.core import cloq as tcloq
from repro_torch.core import costmodel as tcm
from repro_torch.core import loftq as tloftq
from repro_torch.core import optq as toptq
from repro_torch.core import pipeline as tp
from repro_torch.core import recipe as tr
from repro_torch.core.allocate import default_grid
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.mesh import (data_axes_of, make_local_mesh,
                                     make_model_mesh, pcontext_for)
from repro_torch.models import parallel
from repro_torch.models.modules import QSpec
from repro_torch.utils import tree_paths

METHODS = ("cloq", "gptq", "loftq", "qlora", "rtn")


def _np(tree):
    """A (gathered) tree as numpy leaves, bf16 widened to f32."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    assert not parallel.is_sharded(tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _tasks(Ws, Hs, seed=0):
    return [tb.LayerTask(f"l{i}", None, torch.from_numpy(W),
                         torch.from_numpy(H), tb.task_key(seed, i))
            for i, (W, H) in enumerate(zip(Ws, Hs))]


def _buckets(inp, mesh, out):
    """Every method's sharded bucket (n = 48), the replicated fallback
    (n = 45), the progress lines and each rank's block widths."""
    qspec = QSpec(**inp["qs"])
    tasks = _tasks(inp["Ws"], inp["Hs"])
    for method in METHODS:
        spec = next(iter(tb.plan_buckets(tasks, qspec, method, mesh=mesh)))
        lines: list[str] = []
        got = tb.quantize_layer_batch(tasks, qspec, method, mesh=mesh,
                                      progress=lines.append)
        local = got[0]["qcodes"].to_local().shape[-1]
        lora_a = got[0]["lora_a"]
        assert parallel.is_sharded(lora_a)
        assert lora_a.placements[0].is_replicate()
        ref = tb.quantize_layer_batch(tasks, qspec, method)
        for g, r in zip(got, ref):       # random A: the unsharded bits
            if method in ("gptq", "qlora", "rtn"):
                assert torch.equal(g["lora_a"].to_local(), r["lora_a"])
                assert not g["lora_b"].to_local().any()
        out[f"bucket.{method}"] = {
            "n_shards": spec.n_shards, "local_cols": int(local),
            "lines": lines, "leaves": _np(parallel.gather_tree(got)),
            "unsharded": _np(ref)}
    tasks45 = _tasks(inp["Ws45"], inp["Hs45"])
    spec = next(iter(tb.plan_buckets(tasks45, qspec, "cloq", mesh=mesh)))
    got = tb.quantize_layer_batch(tasks45, qspec, "cloq", mesh=mesh)
    ref = tb.quantize_layer_batch(tasks45, qspec, "cloq")
    assert not any(parallel.tree_has_sharded(g) for g in got)
    out["bucket45"] = {"n_shards": spec.n_shards,
                       "equal": all(torch.equal(g[k], r[k])
                                    for g, r in zip(got, ref) for k in r)}


def _factors(inp, mesh, out):
    """The Gram-trick cores over the group against no group, the per-layer
    sharded wrappers and the sharded per-site solve."""
    group = parallel.axis_group(mesh)
    dW = torch.from_numpy(inp["dW"])
    cols = parallel.local_slice(dW, (None, "model"), mesh)
    U, S, V_l = tloftq.svd_lowrank_topr(cols, 8, group)
    U0, S0, V0 = tloftq.svd_lowrank_topr(dW, 8)
    out["topr"] = {"U": _np(U), "S": _np(S), "U0": _np(U0), "S0": _np(S0),
                   "V": _np(parallel.full_tensor(parallel.distribute_local(
                       V_l.contiguous(), ("model", None), mesh))),
                   "V0": _np(V0)}
    H = torch.from_numpy(inp["H"])
    Hreg = tcloq.regularize_gram(H)
    R, Rinv = tcloq.gram_root(Hreg)
    A, B_l = tcloq.cloq_lowrank_local(R, Rinv, cols, 8, "paper", group)
    B = parallel.full_tensor(parallel.distribute_local(
        B_l.contiguous(), ("model", None), mesh))
    A0, B0 = tcloq.cloq_lowrank_local(R, Rinv, dW, 8)
    out["lowrank"] = {"A": _np(A), "B": _np(B), "A0": _np(A0),
                      "B0": _np(B0)}
    W = torch.from_numpy(inp["W"])
    cfg = QuantConfig(bits=4, group_size=16)
    outs = toptq.optq_quantize_sharded(W, H, cfg, mesh)
    assert all(o.to_local().shape[-1] == W.shape[1] // 2 for o in outs)
    out["optq"] = [_np(parallel.full_tensor(o)) for o in outs]
    A, B = tcloq.cloq_init_sharded(Hreg, dW, 8, mesh)
    out["cloq_init"] = {"A": _np(parallel.full_tensor(A)),
                        "B": _np(parallel.full_tensor(B))}
    pl = tb.per_layer_sharded_dispatch(_tasks(inp["Ws"], inp["Hs"]),
                                       QSpec(**inp["qs"]), mesh)
    out["per_layer"] = [{"lora_a": _np(parallel.full_tensor(A)),
                         "lora_b": _np(parallel.full_tensor(B))}
                        for A, B in pl]
    Hs = torch.from_numpy(inp["Hs_site"])
    As, Bs = tcloq.cloq_site_lora(Hs, dW, 8, mesh=mesh)
    assert Bs.to_local().shape == (Hs.shape[0], dW.shape[1] // 2, 8)
    out["site_lora"] = {"As": _np(parallel.full_tensor(As)),
                        "Bs": _np(parallel.full_tensor(Bs))}


def _model(inp, name, mesh, out, ckpt_dir=None):
    """``quantize_model(mesh=)`` against the sequential engine (in the
    test); with ``ckpt_dir`` the sharded tree is saved with its manifest
    and restored sharded, each rank's blocks bit-equal."""
    cfg, params, calib = inp[f"{name}.cfg"], inp[f"{name}.params"], \
        inp[f"{name}.calib"]
    recipe = tr.QuantRecipe.single("cloq", QSpec(**inp["model_qs"]))
    lines: list[str] = []
    qp, qcfg, _ = tp.quantize_model(params, cfg, calib, recipe=recipe,
                                    engine="batched", mesh=mesh,
                                    progress=lines.append)
    full = parallel.gather_tree(qp)
    out[f"model.{name}"] = {"lines": lines, "leaves": _np(
        tree_paths(tp.to_eager_params(full, qcfg)))}
    if ckpt_dir is None:
        return
    manifest = tp.quantization_manifest(qcfg, recipe=recipe, mesh=mesh)
    ckpt.save_tree(qp, ckpt_dir, 1, manifest=manifest)
    dist.barrier()
    back, meta = ckpt.restore_tree(ckpt_dir, mesh=mesh)
    flat, want = tree_paths(back), tree_paths(qp)
    assert set(flat) == set(want)
    n_sharded = 0
    for p, leaf in want.items():
        got = flat[p]
        assert parallel.is_sharded(got) == parallel.is_sharded(leaf), p
        if parallel.is_sharded(leaf):
            n_sharded += 1
            assert got.placements == leaf.placements, p
        assert torch.equal(parallel.local_of(got), parallel.local_of(leaf)), p
    out[f"restore.{name}"] = {"sharded_leaves": n_sharded,
                              "manifest": meta[ckpt.MANIFEST_KEY]}


def _sweep(inp, mesh, out):
    """The sharded sweep against the unsharded one, and the plan
    ``allocate_plan(mesh=)`` picks."""
    tasks = []
    for i, (W, H) in enumerate(zip(inp["Ws"], inp["Hs"])):
        for j, (method, bits) in enumerate((("cloq", 2), ("gptq", 4),
                                            ("loftq", 2), ("rtn", 4))):
            site = tr.SiteSpec(method, QSpec(bits=bits, group_size=16,
                                             rank=8))
            tasks.append(tb.LayerTask(f"l{i}", None, torch.from_numpy(W),
                                      torch.from_numpy(H),
                                      tb.task_key(0, i), site=site))
    lines: list[str] = []
    errs = tb.evaluate_layer_batch(tasks, mesh=mesh, progress=lines.append)
    ref = tb.evaluate_layer_batch(tasks)
    cfg, params, calib = inp["dense.cfg"], inp["dense.params"], \
        inp["dense.calib"]
    grid = default_grid(bits=(2, 4), methods=("cloq", "rtn"), ranks=(0, 8))
    plans = [tp.allocate_plan(params, cfg, calib, inp["budget"], grid=grid,
                              qspec=QSpec(**inp["model_qs"]), mesh=m)
             for m in (mesh, None)]
    out["sweep"] = {"errs": errs, "ref": ref, "lines": lines,
                    "recipes": [p.recipe.to_dict() for p in plans],
                    "errors": [p.total_error for p in plans]}


def run(rank: int, workdir: str) -> None:
    torch.manual_seed(0)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_model_mesh(2, device_type="cpu")
    assert parallel.axis_size(mesh) == 2
    m2 = make_local_mesh(1, 2, device_type="cpu")
    pc = pcontext_for(m2)
    parallel.reset_allreduce_stats()
    out: dict = {"local_mesh": {
        "names": list(m2.mesh_dim_names),
        "sizes": [parallel.axis_size(m2, ax) for ax in m2.mesh_dim_names],
        "data_axes": list(data_axes_of(m2)), "pctx_data": pc.data_axes,
        "pctx_model": pc.model_axis}}
    _buckets(inp, mesh, out)
    _factors(inp, mesh, out)
    _model(inp, "dense", mesh, out,
           ckpt_dir=os.path.join(workdir, "ckpt"))
    _model(inp, "moe", mesh, out)
    _model(inp, "hybrid", mesh, out)
    _sweep(inp, mesh, out)
    out["allreduce"] = dict(parallel.ALLREDUCE_STATS)
    cal = tcm.calibrate(mesh, path=os.path.join(workdir, "cal.json"),
                        force=True, device="cpu")
    tables = [None] * dist.get_world_size()
    dist.all_gather_object(tables, dataclasses.asdict(cal))
    assert tables[0] == tables[1]        # rank 0's table on every rank
    out["calibration"] = tables[0]
    if rank == 0:
        with open(os.path.join(workdir, "outputs.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()


def cuda_bucket(rank: int, workdir: str) -> None:
    """One CLoQ bucket on ``cuda:0`` over the 2-rank gloo mesh: the tasks
    of ``workdir/bucket.pt`` (``Ws (L, m, n)``, ``Hs (L, m, m)``, the spec's
    ``qs``); rank 0 writes the gathered leaves to ``workdir/sharded.pt``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(os.path.join(workdir, "bucket.pt"))
    mesh = make_model_mesh(2)
    tasks = [tb.LayerTask(f"l{i}", None, W.to(dev), H.to(dev),
                          tb.task_key(0, i))
             for i, (W, H) in enumerate(zip(inp["Ws"], inp["Hs"]))]
    spec = next(iter(tb.plan_buckets(tasks, QSpec(**inp["qs"]), "cloq",
                                     mesh=mesh)))
    assert spec.n_shards == 2
    got = tb.quantize_layer_batch(tasks, QSpec(**inp["qs"]), "cloq",
                                  mesh=mesh)
    full = parallel.gather_tree(got)
    if rank == 0:
        torch.save([{k: v.cpu() for k, v in g.items()} for g in full],
                   os.path.join(workdir, "sharded.pt"))
