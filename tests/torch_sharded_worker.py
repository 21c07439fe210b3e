"""Rank bodies of the port's sharded fine-tuning tests
(``tests/test_torch_sharded_train.py``): run under ``repro_torch.launch.
mesh.spawn_ranks`` with 4 gloo ranks on the CPU.  Imports torch and
``repro_torch`` only, so a rank does not pay for importing JAX.

``run(rank, workdir)`` reads ``workdir/inputs.pt`` (written by the test),
runs every scenario on a ``(data 2, model 2)`` mesh (and JAX's 4-column
case and the sequence-sharded decode on a ``(1, 4)`` one), gathers what it
compares and rank 0 writes ``workdir/outputs.pkl``: numpy arrays and plain
data.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh, pcontext_for
from repro_torch.launch.shardings import param_specs
from repro_torch.models import moe, parallel
from repro_torch.models.transformer import init_decode_cache
from repro_torch.optim import ef_psum_int8, merge_params
from repro_torch.utils import set_path, tree_paths


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flat_np(tree) -> dict:
    return {k: _np(v) for k, v in tree_paths(parallel.gather_tree(tree)).items()}


def distribute(tree, mesh) -> dict:
    """Each rank's block of a full tree under :func:`param_specs`."""
    shard = tree_paths(steps.named(param_specs(tree, mesh), mesh))
    out: dict = {}
    for k, v in tree_paths(tree).items():
        set_path(out, k, shard[k].distribute(v))
    return out


def distribute_state(state, mesh) -> dict:
    flat = tree_paths(steps.named(steps.state_pspecs(state, mesh), mesh))
    out: dict = {}
    for k, v in tree_paths(state).items():
        set_path(out, k, flat[k].distribute(v))
    return out


def _same_on_every_rank(x) -> bool:
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, x)
    return all(g == got[0] for g in got)


def train(sc: dict, state, pctx) -> dict:
    """3 steps of ``sc``'s config from the (DTensor) ``state``: each step's
    metrics and collectives, the step-1 gradients and trainable leaves
    gathered, which train leaves are sharded."""
    cfg, ocfg, batches = sc["cfg"], sc["ocfg"], sc["batches"]
    _, grads = steps.value_and_grad(cfg, pctx, state, batches[0])
    grads = parallel.delocalize(grads, parallel.localize(state)["train"])
    out = {"grads": _flat_np(grads), "metrics": [], "collectives": [],
           "sharded": sorted(k for k, v in tree_paths(state["train"]).items()
                             if any(p.is_shard() for p in v.placements))}
    step = steps.make_train_step(cfg, ocfg, pctx)
    for i, b in enumerate(batches):
        parallel.reset_collective_stats()
        state, m = step(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["collectives"].append(parallel.collective_stats())
        if i == 0:
            out["leaves"] = _flat_np(state["train"])
    out["equal_on_ranks"] = _same_on_every_rank(out["metrics"])
    return out


def decode(sc: dict, params, pctx, steps_n: int = 3) -> dict:
    cfg = sc["cfg"]
    cache = init_decode_cache(cfg, 4, 16, device="cpu", pctx=pctx)
    step = steps.make_decode_step(cfg, pctx)
    tokens = sc["prompt"]
    logits = []
    for _ in range(steps_n):
        lg, cache = step(params, cache, tokens)
        logits.append(_np(lg))
        tokens = lg.argmax(-1, keepdim=True)
    return {"logits": logits,
            "cache_local": list(parallel.local_of(cache["k"]).shape)}


def seq_decode(sc: dict, mesh) -> dict:
    """The decode of ``sc``'s model on ``mesh``, whose model axis does not
    divide its KV heads, so that ``cache_specs`` shards the cache's
    sequence: the given tokens from position 0, each step's logits and
    collectives, then one step at the vector ``idx`` of ``sc`` (its rows
    in different shards)."""
    pctx = pcontext_for(mesh)
    cfg = sc["cfg"]
    params = distribute(sc["params"], mesh)
    cache = init_decode_cache(cfg, 4, sc["cache_len"], device="cpu",
                              pctx=pctx)
    step = steps.make_decode_step(cfg, pctx)
    out: dict = {"logits": [], "collectives": []}
    with torch.no_grad():
        for tok in sc["tokens"]:
            parallel.reset_collective_stats()
            lg, cache = step(params, cache, tok)
            out["collectives"].append(parallel.collective_stats())
            out["logits"].append(_np(lg))
        lg, cache = step(params, dict(cache, idx=sc["vec_idx"]),
                         sc["vec_token"])
    out["vec_logits"] = _np(lg)
    out["cache_local"] = list(parallel.local_of(cache["k"]).shape)
    out["cache_layout"] = parallel.spec_of_placements(
        cache["k"].placements, mesh, cache["k"].dim())
    digest = hashlib.sha1(b"".join(a.tobytes() for a in out["logits"] +
                                   [out["vec_logits"]])).hexdigest()
    out["equal_on_ranks"] = _same_on_every_rank(digest)
    return out


def whole_scales_linear(sc: dict, mesh) -> dict:
    """A row linear whose group-scale rows the model axis does not divide
    (``param_specs`` leaves them whole beside the sharded codes): the
    sharded ``linear_apply`` against the unsharded one on the same input,
    output and gradients."""
    from repro_torch.models.modules import QSpec, linear_apply
    qs = QSpec(bits=4, group_size=sc["group"], rank=sc["rank"])
    full = sc["leaves"]
    p = distribute({"blocks": {"attn": {"o": full}}}, mesh)
    p = parallel.localize(p)["blocks"]["attn"]["o"]
    out = {"whole": [k for k, v in p.items()
                     if not parallel.model_sharded(v)]}
    res = []
    for leaves in (p, full):
        a = parallel.tag(leaves["lora_a"].detach().requires_grad_(True),
                         parallel.layout_of(leaves["lora_a"]))
        x = sc["x"].clone().requires_grad_(True)
        y = linear_apply(dict(leaves, lora_a=a), x, qs)
        ga, gx = torch.autograd.grad((y * sc["dy"]).sum(), (a, x))
        if parallel.model_sharded(a):
            ga = parallel.full_tensor(parallel.distribute_local(
                ga, parallel.layout_of(a).spec, mesh))
        res.append((y, ga, gx))
    out["err"] = [float((u - w).abs().max()) for u, w in zip(*res)]
    return out


def run_seq(rank: int, workdir: str) -> None:
    """The sequence-sharded decode cases of ``workdir/inputs.pt`` alone,
    on a ``(1, 4)`` mesh; rank 0 writes ``workdir/outputs.pkl``."""
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh4 = make_local_mesh(1, 4, device_type="cpu")
    out = {name: seq_decode(sc, mesh4) for name, sc in inp.items()}
    if rank == 0:
        with open(os.path.join(workdir, "outputs.pkl"), "wb") as f:
            pickle.dump(out, f)


def run(rank: int, workdir: str) -> None:
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_local_mesh(2, 2, device_type="cpu")
    pctx = pcontext_for(mesh)
    out: dict = {}
    for name in ("all", "all_seq", "headsplit"):
        sc = inp[name]
        state = distribute_state(steps.build_state(sc["params"], sc["ocfg"]),
                                 mesh)
        out[name] = train(sc, state, pctx)
    # the quantized model restored from the unsharded engine's checkpoint
    for name in ("lora", "lora_seq"):
        sc = inp[name]
        shapes = steps.build_state(sc["params"], sc["ocfg"])
        state, _ = ckpt.restore_tree(
            os.path.join(workdir, "ckpt"),
            shardings=steps.named(steps.state_pspecs(shapes, mesh), mesh))
        out[name] = train(sc, state, pctx)
        if name == "lora":
            out[name]["layouts"] = {
                k: parallel.spec_of_placements(v.placements, v.device_mesh,
                                               v.dim())
                for k, v in tree_paths(merge_params(
                    state["train"], state["frozen"])).items()
                if k.startswith("blocks.attn.") or k.startswith("embed")}
            params = merge_params(state["train"], state["frozen"])
            out["decode"] = decode(sc, params, pctx)
    # expert parallelism: the MoE block on the rank's data shard
    sc = inp["moe"]
    p = distribute({"moe": sc["params"]}, mesh)["moe"]
    r_data = mesh.get_local_rank("data")
    x = sc["x"].chunk(2, dim=0)[r_data]
    with moe.record_drops() as drops:
        y, aux = moe.moe_apply(parallel.localize(p), sc["cfg"], x,
                               pctx=pctx)
    parts = [None] * 4
    dist.all_gather_object(parts, (r_data, _np(y), float(aux),
                                   [(int(d), int(n)) for d, n in drops]))
    out["moe"] = {"y": [next(pt[1] for pt in parts if pt[0] == d)
                        for d in range(2)],
                  "aux": [pt[2] for pt in parts],
                  "drops": [pt[3] for pt in parts],
                  "local_experts": int(parallel.local_of(
                      p["gate"]["w"]).shape[0])}
    # int8 error feedback over the data group: two syncs
    g = inp["ef"]
    dgroup = parallel.axis_group(mesh, "data")
    res = {"g": torch.zeros(g["g"].shape[1:])}
    ef = []
    for grads in (g["g"], g["g2"]):
        synced, res = ef_psum_int8({"g": grads[r_data]}, res, dgroup)
        ef.append({"synced": _np(synced["g"]), "res": _np(res["g"])})
    parts = [None] * 4
    dist.all_gather_object(parts, (r_data, ef))
    out["ef"] = {d: next(pt[1] for pt in parts if pt[0] == d)
                 for d in range(2)}
    out["whole_scales"] = whole_scales_linear(inp["whole_scales"], mesh)
    # JAX's own test mesh shape on 4 ranks: (1, 4), 8 k/v columns a rank;
    # and 2 q heads of 32 over 4 ranks, 16 q columns a rank
    mesh4 = make_local_mesh(1, 4, device_type="cpu")
    for name in ("cols4", "qsplit"):
        sc = inp["all" if name == "cols4" else name]
        state = distribute_state(steps.build_state(sc["params"],
                                                   sc["ocfg"]), mesh4)
        out[name] = train(sc, state, pcontext_for(mesh4))
    # the sequence-sharded decode: KV heads the model axis does not divide
    for name in ("seq_qwen", "seq_minicpm"):
        out[name] = seq_decode(inp[name], mesh4)
    if rank == 0:
        with open(os.path.join(workdir, "outputs.pkl"), "wb") as f:
            pickle.dump(out, f)
