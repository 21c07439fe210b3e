"""Port parity: the sharded fine-tuning step and decode on a ``(data 2,
model 2)`` ``torch.distributed`` mesh (tensor, sequence, data and expert
parallelism, int8 error-feedback sync) against the JAX package.

The port's ranks (4 gloo processes on the CPU, ``repro_torch.launch.mesh.
spawn_ranks``, bodies in ``tests/torch_sharded_worker.py``) run once for
the whole file.  JAX's own sharded train step cannot be the oracle: its
test (``tests/test_distributed.py::test_pjit_train_step_matches_local``)
fails in the installed JAX's vocab-sharded embedding gather before it
computes anything, and GSPMD does not change the math.  So the sharded
step is held against JAX's *unsharded* ``make_train_step(..., LOCAL)``, as
that test holds pjit against it.  JAX's expert-parallel ``moe_apply`` and
``ef_psum_int8`` under ``shard_map`` do run here: they are held directly,
in a subprocess over 4 fake devices beside the ranks.

Tolerances and their reasons (f32 throughout):
  * the loss of each of 3 steps: rtol 2e-4 (the JAX test's bound,
    ``tests/test_distributed.py:47-48``);
  * step 1's gradient norm: rtol 1e-4, and each trainable leaf's gradient
    within 1e-3 relative + 1e-4 of its largest entry (the same f32 sums,
    split over ranks and summed in another order; a missing reduction over
    "model" is off by about half the gradient);
  * the trainable leaves after step 1: atol 2 * lr (AdamW's first step
    moves each weight by about lr * sign(g), so where |g| is at noise
    level a sign can differ, as ``tests/test_torch_train.py`` holds them);
  * the sharded decode's logits against JAX's unsharded decode: 1e-4;
  * the MoE block: y atol 2e-5 against JAX's expert-parallel and local
    ``moe_apply``, aux rtol 1e-5 against the expert-parallel one and 5e-2
    against the local one (the JAX test's bounds: aux is the mean of the
    data shards' load-balance losses, not the global batch's);
  * ``ef_psum_int8``: the synced mean and the residuals within 1e-6 of
    JAX's (the same f32 operations), and the JAX test's bounds (synced
    error at most 2 LSB of the exact mean, residual at most 1 LSB).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.core import pipeline as jp
from repro.core.health import HealthPolicy
from repro.core.recipe import QuantRecipe
from repro.launch import shardings as jsh
from repro.launch import steps as jsteps
from repro.models import modules as jmod
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.parallel import LOCAL
from repro.optim import OptConfig as JOptConfig
from repro.optim import merge_params as jmerge
from repro_torch import configs as tc
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data import DataConfig, TokenStream
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as tt
from repro_torch.optim import OptConfig
from repro_torch.utils import tree_paths as tpaths
from tests import torch_sharded_worker
from tests.torch_parity import configs, port_params, to_np, worker_threads
from tests.util import SRC

LR = 1e-3
QSPEC = dict(bits=4, group_size=16, rank=8)
# minicpm's smoke widths (72, 144) in groups whose count the model axis 4
# divides, so its row linears shard their scales as the others do
QSPEC_GROUP = {"minicpm-2b": 6}
# the JAX test's model (tests/test_distributed.py:19-21)
BASE = dict(name="t", family="dense", n_layers=2, d_model=64, vocab=128,
            n_heads=4, n_kv_heads=2, d_ff=128)
MOE = dict(n_experts=8, top_k=2, d_model=32, d_ff=64, capacity_factor=8.0)


def _cfgs(**kw):
    return (jt.ModelConfig(**{**BASE, **kw}, dtype=jnp.float32),
            tt.ModelConfig(**{**BASE, **kw}, dtype=torch.float32))


def _batches(vocab: int, n: int = 3) -> list:
    ds = TokenStream(DataConfig(vocab=vocab, seq_len=32, global_batch=8,
                                seed=2))
    return [ds.next_batch() for _ in range(n)]


def _jb(b: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _jax_ref(cfg, ocfg, params, batches) -> dict:
    """JAX's unsharded step: step 1's gradients, 3 steps' metrics, the
    trainable leaves after step 1."""
    st = jsteps.build_state(params, ocfg)

    def loss_of(tp, b):
        return jt.loss_fn(jmerge(tp, st["frozen"]), cfg, b, pctx=LOCAL)
    (_, _), g = jax.value_and_grad(loss_of, has_aux=True)(
        st["train"], _jb(batches[0]))
    f = jax.jit(jsteps.make_train_step(cfg, ocfg, LOCAL))
    out = {"grads": {k: np.asarray(v) for k, v in tpaths(g).items()},
           "metrics": []}
    for i, b in enumerate(batches):
        st, m = f(st, _jb(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["leaves"] = {k: np.asarray(v)
                             for k, v in tpaths(st["train"]).items()}
    return out


_JAX_SHARDED = """
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.launch.mesh import pcontext_for
    from repro.models.moe import MoEConfig, moe_apply
    from repro.optim import ef_psum_int8
    inp = pickle.load(open({inp!r}, "rb"))
    cfg = MoEConfig(**inp["moe_cfg"])
    p = jax.tree.map(jnp.asarray, inp["moe_params"])
    x = jnp.asarray(inp["x"])
    y_loc, aux_loc = moe_apply(p, cfg, x)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    y, aux = moe_apply(p, cfg, x, pctx=pcontext_for(mesh))
    dmesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def f(g_local, res):
        synced, new_res = ef_psum_int8({{"g": g_local[0]}}, {{"g": res[0]}},
                                       "data")
        return synced["g"], new_res["g"][None]

    fn = shard_map(f, mesh=dmesh, in_specs=(P("data", None), P("data", None)),
                   out_specs=(P(None), P("data", None)), check_rep=False)
    s1, r1 = fn(jnp.asarray(inp["g"]), jnp.zeros(inp["g"].shape))
    s2, r2 = fn(jnp.asarray(inp["g2"]), r1)
    out = {{"y": np.asarray(y), "aux": float(aux), "y_local":
           np.asarray(y_loc), "aux_local": float(aux_loc),
           "ef": [(np.asarray(s1), np.asarray(r1)),
                  (np.asarray(s2), np.asarray(r2))]}}
    with open({out!r}, "wb") as fh:
        pickle.dump(out, fh)
"""


def _start_jax(code: str, n_devices: int) -> subprocess.Popen:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                        f"platform_device_count={n_devices}").strip()
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _quantized(arch: str = "qwen3-1.7b"):
    """A smoke model (qwen3's unless ``arch``) quantized by JAX's engine
    (CLoQ 4/16/8, f32), carried into the port."""
    cfg_j, cfg_t = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    qspec = dict(QSPEC, group_size=QSPEC_GROUP.get(arch, QSPEC["group_size"]))
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    calib = [_jb(TokenStream(DataConfig(vocab=cfg_j.vocab, seq_len=32,
                                        global_batch=2, seed=5)
                             ).next_batch())]
    qj, cfg_j, _ = jp.quantize_model(
        pj, cfg_j, calib,
        recipe=QuantRecipe.single("cloq", jmod.QSpec(**qspec)),
        engine="sequential", policy=HealthPolicy(enabled=False))
    cfg_t = dataclasses.replace(cfg_t, quant=tmod.QSpec(**qspec))
    return qj, cfg_j, port_params(qj, cfg_t), cfg_t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: the ranks' outputs and JAX's references."""
    work = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    jmoe_cfg = jmoe.MoEConfig(**MOE)
    pm = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0),
                                                jmoe_cfg,
                                                dtype=jnp.float32))
    x = rng.normal(size=(4, 16, 32)).astype(np.float32)
    g = rng.normal(size=(2, 64)).astype(np.float32)
    g2 = rng.normal(size=(2, 64)).astype(np.float32)
    with open(work / "jax_in.pkl", "wb") as f:
        pickle.dump({"moe_cfg": MOE, "moe_params": pm, "x": x, "g": g,
                     "g2": g2}, f)
    jax_proc = _start_jax("import numpy as np\n" + textwrap.dedent(
        _JAX_SHARDED).format(inp=str(work / "jax_in.pkl"),
                             out=str(work / "jax_out.pkl")), 4)
    ref, inp = {}, {}
    oj = JOptConfig(lr=LR, trainable="all", total_steps=5)
    ot = OptConfig(lr=LR, trainable="all", total_steps=5)
    for name, kw in (("all", {}), ("headsplit", {"n_kv_heads": 1}),
                     ("qsplit", {"n_heads": 2, "n_kv_heads": 2,
                                 "head_dim": 32})):
        cj, ct = _cfgs(**kw)
        pj = jt.init_params(jax.random.PRNGKey(0), cj)
        batches = _batches(ct.vocab)
        inp[name] = {"cfg": ct, "ocfg": ot, "params": port_params(pj, ct),
                     "batches": batches}
        ref[name] = _jax_ref(cj, oj, pj, batches)
    inp["all_seq"] = dict(inp["all"], cfg=dataclasses.replace(
        inp["all"]["cfg"], seq_shard=True))
    qj, cfg_j, qt, cfg_t = _quantized()
    oj = JOptConfig(lr=LR, trainable="lora", total_steps=5)
    ot = OptConfig(lr=LR, trainable="lora", total_steps=5)
    batches = _batches(cfg_t.vocab)
    prompt = torch.tensor([[3], [5], [7], [11]])
    inp["lora"] = {"cfg": cfg_t, "ocfg": ot, "params": qt,
                   "batches": batches, "prompt": prompt}
    inp["lora_seq"] = dict(inp["lora"], cfg=dataclasses.replace(
        cfg_t, seq_shard=True))
    ref["lora"] = _jax_ref(cfg_j, oj, qj, batches)
    # the unsharded engine's checkpoint the ranks restore sharded
    ckpt.save_tree(tsteps.build_state(qt, ot), str(work / "ckpt"), 1)
    cache = jt.init_decode_cache(cfg_j, 4, 16)
    tokens, logits = jnp.asarray(prompt.numpy()), []
    for _ in range(3):
        lg, cache = jt.decode_step(qj, cfg_j, cache, tokens)
        logits.append(np.asarray(lg))
        tokens = jnp.argmax(lg, -1)[:, None]
    ref["decode"] = logits
    for name, arch, kernel in (("seq_qwen", "qwen3-1.7b", False),
                               ("seq_minicpm", "minicpm-2b", True)):
        inp[name], ref[name] = _seq_decode_case(arch, kernel)
    inp["moe"] = {"cfg": tt.MoEConfig(**MOE),
                  "params": jax.tree.map(
                      lambda a: torch.from_numpy(np.array(a)), pm),
                  "x": torch.from_numpy(x)}
    inp["ef"] = {"g": torch.from_numpy(g), "g2": torch.from_numpy(g2)}
    inp["whole_scales"] = _whole_scales_case(rng)
    torch.save(inp, work / "inputs.pt")
    try:
        tmesh.spawn_ranks(torch_sharded_worker.run, 4, backend="gloo",
                          device="cpu", args=(str(work),),
                          threads=max(1, worker_threads() // 4),
                          store_dir=str(work))
    finally:
        _, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, f"JAX reference failed:\n{stderr}"
    with open(work / "jax_out.pkl", "rb") as f:
        ref.update(pickle.load(f))
    with open(work / "outputs.pkl", "rb") as f:
        port = pickle.load(f)
    ref.update({"all_seq": ref["all"], "lora_seq": ref["lora"],
                "cols4": ref["all"], "ef_g": g})
    return port, ref


SEQ_CACHE = 16        # 4 keys a rank on the (1, 4) mesh
SEQ_TOKENS = 12       # positions 0..11: rank 3's keys stay empty
SEQ_VEC_IDX = (2, 5, 9, 14)   # one row in each rank's shard


def _seq_decode_case(arch: str, kernel: bool) -> tuple[dict, dict]:
    """A CLoQ smoke model whose KV heads the model axis 4 does not divide
    (qwen3: 2 KV heads, half a head and one q head a rank; minicpm: 6 of
    12 columns, 1.5 q heads a rank): JAX's unsharded greedy decode from
    position 0 for ``SEQ_TOKENS`` steps, then one step at the vector
    ``idx`` ``SEQ_VEC_IDX``, and the port's unsharded decode fed the same
    tokens (the kernel wrappers with ``kernel``: the plain versions on the
    CPU).  Returns (the ranks' inputs, the references)."""
    qj, cfg_j, qt, cfg_t = _quantized(arch)
    cfg_t = dataclasses.replace(cfg_t, quant=dataclasses.replace(
        cfg_t.quant, use_kernel=kernel))
    cache = jt.init_decode_cache(cfg_j, 4, SEQ_CACHE)
    tok = jnp.asarray([[3], [5], [7], [11]])
    tokens, logits = [], []
    for _ in range(SEQ_TOKENS):
        tokens.append(torch.from_numpy(np.array(tok)))
        lg, cache = jt.decode_step(qj, cfg_j, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None]
    vec_idx = jnp.asarray(SEQ_VEC_IDX, jnp.int32)
    vec_lg, _ = jt.decode_step(qj, cfg_j, dict(cache, idx=vec_idx), tok)
    port = {"logits": []}
    pc = tt.init_decode_cache(cfg_t, 4, SEQ_CACHE, device="cpu")
    with torch.no_grad():
        for t in tokens:
            lg, pc = tt.decode_step(qt, cfg_t, pc, t)
            port["logits"].append(to_np(lg))
        pc = dict(pc, idx=torch.tensor(SEQ_VEC_IDX, dtype=torch.int32))
        lg, _ = tt.decode_step(qt, cfg_t, pc, torch.from_numpy(
            np.array(tok)))
    port["vec_logits"] = to_np(lg)
    inp = {"cfg": cfg_t, "params": qt, "cache_len": SEQ_CACHE,
           "tokens": tokens,
           "vec_idx": torch.tensor(SEQ_VEC_IDX, dtype=torch.int32),
           "vec_token": torch.from_numpy(np.array(tok))}
    return inp, {"logits": logits, "vec_logits": np.asarray(vec_lg),
                 "port": port, "cfg": cfg_t}


def _whole_scales_case(rng) -> dict:
    """A 4-bit row linear of K = 64 input features in one group of 64:
    its one scale row stays whole over "model" 2 beside its sharded codes
    (``_linear_sharded``'s gathered path)."""
    from repro_torch.core.quantizer import pack_codes
    K, N, r = 64, 48, 8
    codes = torch.from_numpy(rng.integers(0, 16, (K, N)).astype(np.uint8))
    return {"group": 64, "rank": r,
            "leaves": {
                "qcodes": pack_codes(codes, 4),
                "scales": torch.from_numpy(
                    rng.uniform(0.01, 0.02, (1, N)).astype(np.float32)),
                "zeros": torch.full((1, N), 8.0),
                "lora_a": torch.from_numpy(
                    rng.normal(size=(K, r)).astype(np.float32)),
                "lora_b": torch.from_numpy(
                    rng.normal(size=(N, r)).astype(np.float32))},
            "x": torch.from_numpy(rng.normal(size=(3, K)).astype(np.float32)),
            "dy": torch.from_numpy(rng.normal(size=(3, N)).astype(
                np.float32))}


def _held(got: dict, want: dict) -> None:
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-4,
                                   err_msg=f"step {i} loss")
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                               want["metrics"][0]["grad_norm"], rtol=1e-4)
    assert got["equal_on_ranks"]
    assert sorted(got["grads"]) == sorted(want["grads"])
    for path, w in want["grads"].items():
        if not w.size:
            continue
        np.testing.assert_allclose(got["grads"][path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)
        np.testing.assert_allclose(got["leaves"][path], want["leaves"][path],
                                   atol=2 * LR, err_msg=path)


@pytest.mark.parametrize("name", ["all", "all_seq", "lora", "lora_seq"])
def test_sharded_step_matches_jax_unsharded(runs, name):
    """3 steps on the (2, 2) mesh against JAX's unsharded step:
    ``trainable="all"`` (vocab-parallel embedding and head trained) and
    ``"lora"`` on a CLoQ-quantized model restored from the unsharded
    engine's checkpoint with ``shardings=named(state_pspecs(...))``, each
    with and without ``seq_shard``; metrics equal on every rank."""
    port, ref = runs
    _held(port[name], ref[name])
    assert any(k.endswith("lora_b") for k in port[name]["sharded"]) or \
        name.startswith("all")


def test_layouts_follow_param_specs(runs):
    """The restored state's leaves carry ``param_specs``' layouts: a
    column linear's ``lora_b`` and codes sharded, its ``lora_a`` whole; the
    vocab-sharded embedding; a row linear's ``lora_a`` sharded."""
    port, _ = runs
    pl = port["lora"]["layouts"]
    assert pl["blocks.attn.q.lora_a"] == (None, None, None)
    assert pl["blocks.attn.q.lora_b"] == (None, "model", None)
    assert pl["blocks.attn.q.qcodes"] == (None, None, "model")
    assert pl["blocks.attn.o.lora_a"] == (None, "model", None)
    assert pl["blocks.attn.o.lora_b"] == (None, None, None)
    assert pl["embed.w"] == ("model", None)


@pytest.mark.parametrize("name", ["headsplit", "cols4", "qsplit"])
def test_head_splitting_layouts_match_jax(runs, name):
    """Layouts that split a head: 1 KV head of 16 over model 2 (8 columns
    a rank) and JAX's own test mesh shape on 4 ranks, 2 KV heads over
    model 4 (8 columns a rank): k/v gathered to whole heads for the rank's
    q heads; 2 q heads of 32 over model 4 (16 columns a rank): every
    projection gathered and all heads attended on every rank.  The answer
    unchanged."""
    port, ref = runs
    _held(port[name], ref[name])
    assert port[name]["collectives"][0]["all_gather"]["calls"] > 0


def test_row_linear_with_whole_scales(runs):
    """A row linear whose scale rows the model axis does not divide runs
    whole on every rank (its sharded leaves gathered), with the output
    and the gradients of its input and its ``lora_a`` of the unsharded
    linear."""
    port, _ = runs
    got = port["whole_scales"]
    assert got["whole"] == ["scales", "zeros", "lora_b"]
    for err in got["err"]:
        assert err <= 1e-5, got


def test_seq_shard_reduce_scatters(runs):
    """Under ``seq_shard`` the row linears reduce-scatter along S and the
    blocks gather it; without it, neither."""
    port, _ = runs
    for name in ("all_seq", "lora_seq"):
        assert port[name]["collectives"][0]["reduce_scatter"]["calls"] > 0
    assert port["all"]["collectives"][0]["reduce_scatter"]["calls"] == 0


def test_sharded_decode_matches_jax(runs):
    """The quantized model decoded on the mesh (the cache by
    ``cache_specs``: batch over data, KV heads over model) against JAX's
    unsharded ``decode_step``, 3 greedy tokens at batch 4."""
    port, ref = runs
    assert port["decode"]["cache_local"] == [2, 2, 16, 1, 16]
    for got, want in zip(port["decode"]["logits"], ref["decode"]):
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_moe_expert_parallel_matches_jax(runs):
    """``moe_apply`` under the mesh (4 of 8 experts a rank) against JAX's
    expert-parallel ``moe_apply`` over 4 fake devices and its local one."""
    port, ref = runs
    y = np.concatenate(port["moe"]["y"], axis=0)
    np.testing.assert_allclose(y, ref["y"], atol=2e-5)
    np.testing.assert_allclose(y, ref["y_local"], atol=2e-5)
    for aux in port["moe"]["aux"]:
        np.testing.assert_allclose(aux, ref["aux"], rtol=1e-5)
        np.testing.assert_allclose(aux, ref["aux_local"], rtol=5e-2)
    assert port["moe"]["local_experts"] == 4
    assert all(d == 0 for rec in port["moe"]["drops"] for d, _ in rec)


def test_ef_psum_int8_matches_jax(runs):
    """Two error-feedback syncs over the data group against JAX's under
    ``shard_map``, and the JAX test's bounds."""
    port, ref = runs
    for i, (s_j, r_j) in enumerate(ref["ef"]):
        for d in range(2):
            got = port["ef"][d][i]
            np.testing.assert_allclose(got["synced"], s_j, rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got["res"], r_j[d], rtol=1e-6,
                                       atol=1e-7)
    g = ref["ef_g"]
    lsb = np.abs(g).max() / 127
    for d in range(2):
        got = port["ef"][d][0]
        assert np.abs(got["synced"] - g.mean(axis=0)).max() <= 2 * lsb
        assert np.abs(got["res"]).max() <= lsb + 1e-6


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2},
                                  {"data": 16, "model": 16}])
@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_param_and_cache_specs_match_jax(arch, mesh):
    """``param_specs`` and ``cache_specs`` equal JAX's on every config's
    shapes at published size (dense and CLoQ-quantized), on a mesh stub
    with no devices."""
    stub = _MeshStub(mesh)
    cj, ct = jc.get_config(arch), tc.get_config(arch)
    shapes_j = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                     cj))
    shapes_t = tt.init_params(ct, device="meta")
    _same_specs(jsh.param_specs(shapes_j, stub),
                tsh.param_specs(shapes_t, stub))
    qj = jp.quantized_param_shapes(dataclasses.replace(
        cj, quant=jmod.QSpec(bits=4, group_size=64, rank=64)))
    from repro_torch.core.pipeline import quantized_param_shapes
    qt = quantized_param_shapes(dataclasses.replace(
        ct, quant=tmod.QSpec(bits=4, group_size=64, rank=64)))
    _same_specs(jsh.param_specs(qj, stub), tsh.param_specs(qt, stub))
    for B, T in ((8, 128), (1, 96)):
        cache_j = jax.eval_shape(lambda: jt.init_decode_cache(cj, B, T))
        cache_t = tt.init_decode_cache(ct, B, T, device="meta")
        _same_specs(jsh.cache_specs(cj, cache_j, stub, "data"),
                    tsh.cache_specs(ct, cache_t, stub, "data"))


class _MeshStub:
    """A mesh with axis names and sizes and no devices (both packages'
    layout rules read only these)."""

    def __init__(self, sizes: dict):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.shape = dict(sizes)


def _same_specs(want: dict, got: dict) -> None:
    w = {k: tuple(v) for k, v in tpaths(want).items()}
    g = tpaths(got)
    assert sorted(w) == sorted(g)
    bad = {k: (w[k], g[k]) for k in w if w[k] != g[k]}
    assert not bad, list(bad.items())[:5]


def test_shardings_without_a_mesh_are_the_identity():
    """``constrain`` is the identity without a mesh; ``batch_pspecs`` puts
    the batch dim over the data axes unless it is 1, as JAX's."""
    x = torch.arange(6.0)
    assert tsh.constrain(x, None, ("model",)) is x
    _, ct = _cfgs()
    b = {"tokens": torch.zeros(8, 4), "labels": torch.zeros(8, 4)}
    assert tsteps.batch_pspecs(ct, b, "data") == {
        "tokens": ("data", None), "labels": ("data", None)}
    one = {"tokens": torch.zeros(1, 4)}
    assert tsteps.batch_pspecs(ct, one, "data") == {"tokens": (None, None)}
    cj, _ = _cfgs()
    jspec = jsteps.batch_pspecs(cj, "train_4k", "data")
    assert {k: tuple(v) for k, v in jspec.items()} == \
        tsteps.batch_pspecs(ct, b, "data")


def _chip_scripts():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    return root, fc, cs


def test_fault_check_plants_the_sharded_fault():
    """chip_fault_check.py's planted sharded-step fault (a sharded linear's
    whole LoRA factor keeps each rank's part of its gradient) changes
    exactly one line of ``models/modules.py``, the model-axis sum in
    ``_linear_sharded``, and the cases it runs are ``chip_smoke``'s
    ``train_sharded`` checks, whose gradient limit is 8 bf16 roundings."""
    root, fc, cs = _chip_scripts()
    sound = (root / fc.SHARDED_SOURCE).read_text()
    fault = fc.plant_sharded_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert changed == [(fc.SHARDED_SOUND, fc.SHARDED_FAULT)]
    body = fault.split("def _linear_sharded")[1].split("\ndef ")[0]
    assert "copy_to(local[other]" not in body
    with pytest.raises(ValueError):
        fc.plant_sharded_fault(fault)
    assert cs.SHARDED_MESH == (2, 2)
    assert cs.SHARDED_GRAD_REL == 8 * 2.0 ** -8


@pytest.mark.parametrize("name", ["lora", "lora_seq"])
def test_chip_smoke_predicts_the_collectives(runs, name):
    """``chip_smoke.predicted_collectives`` (the layout table's count a
    step) equals the calls the ranks made in each step of the LoRA model
    of the same structure (dense, 2 layers, qk-norm, ``remat="full"``, the
    (2, 2) mesh), with and without ``seq_shard``."""
    port, _ = runs
    _, _, cs = _chip_scripts()
    _, cfg = configs()
    want = cs.predicted_collectives(cfg, name == "lora_seq")
    for step in port[name]["collectives"]:
        assert {k: v["calls"] for k, v in step.items()} == want


@pytest.mark.parametrize("name", ["seq_qwen", "seq_minicpm"])
def test_sequence_sharded_decode_matches_jax(runs, name):
    """The decode on the (1, 4) mesh of a model whose KV heads the model
    axis does not divide: ``cache_specs`` shards the cache's sequence (4
    keys a rank), every rank attends every head over its keys by the
    partial flash attention and the ranks' partials are combined.  Each of
    12 greedy steps from position 0 (rank 3 never holds a valid key) and a
    step at a vector ``idx`` with a row in each shard, against JAX's
    unsharded ``decode_step`` within 1e-4 and the port's unsharded decode;
    the logits the same on every rank."""
    port, ref = runs
    got, want = port[name], ref[name]
    cfg = want["cfg"]
    assert got["cache_layout"][2:] == ("model", None, None)
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    assert got["cache_local"] == [cfg.n_layers, 4, SEQ_CACHE // 4,
                                  cfg.n_kv_heads, hd]
    assert got["equal_on_ranks"]
    for i, (g, w, p) in enumerate(zip(got["logits"], want["logits"],
                                      want["port"]["logits"])):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(g, p, atol=1e-4, err_msg=f"step {i}")
    np.testing.assert_allclose(got["vec_logits"], want["vec_logits"],
                               atol=1e-4)
    np.testing.assert_allclose(got["vec_logits"],
                               want["port"]["vec_logits"], atol=1e-4)


@pytest.mark.parametrize("name", ["seq_qwen", "seq_minicpm"])
def test_chip_smoke_predicts_the_decode_collectives(runs, name):
    """``chip_smoke.predicted_decode_collectives`` (the layout table's count
    a step of the sequence-sharded decode, which the card's ``seq_kv``
    case holds) equals the calls each rank made in every step: per layer
    the q, k and v gathers to whole heads, the partials' MAX and SUM
    all-reduces, o's and the MLP's all-reduce; once the embedding's
    all-reduce and the head's vocab gather."""
    port, ref = runs
    _, _, cs = _chip_scripts()
    want = cs.predicted_decode_collectives(ref[name]["cfg"])
    for step in port[name]["collectives"]:
        assert {k: v["calls"] for k, v in step.items()} == want


def test_fault_check_plants_the_seqkv_fault(tmp_path):
    """chip_fault_check.py's eighth plant (the partial softmaxes combined
    without the rescale by the ranks' max log-sum-exp) changes one line of
    ``models/parallel.py``, and the sequence-sharded decode of this file
    fails on it: the ranks run on a copy of the package with the plant in
    place, their logits far from JAX's."""
    import shutil
    root, fc, cs = _chip_scripts()
    sound = (root / fc.SEQKV_SOURCE).read_text()
    fault = fc.plant_seqkv_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert changed == [(fc.SEQKV_SOUND, fc.SEQKV_FAULT)]
    with pytest.raises(ValueError):
        fc.plant_seqkv_fault(fault)
    assert cs.SEQ_KV_MESH == (1, 8) and cs.SEQ_KV_DECODE == (4, 40, 64)
    inp, ref = _seq_decode_case("qwen3-1.7b", False)
    torch.save({"seq_qwen": inp}, tmp_path / "inputs.pt")
    copy = tmp_path / "fault_src"
    shutil.copytree(root / "src" / "repro_torch", copy / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / fc.SEQKV_SOURCE.relative_to("src")).write_text(fault)
    code = ("import sys; from tests import torch_sharded_worker as w; "
            "from repro_torch.launch import mesh; "
            "mesh.spawn_ranks(w.run_seq, 4, backend='gloo', device='cpu', "
            "args=(sys.argv[1],), threads=1, store_dir=sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy), str(root), SRC]))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "outputs.pkl", "rb") as f:
        got = pickle.load(f)["seq_qwen"]
    err = max(float(np.abs(g - w).max())
              for g, w in zip(got["logits"], ref["logits"]))
    assert err > 1e-2, err


def test_sliding_window_sequence_sharded_cache_raises():
    """A sliding-window cache sharded along its sequence (a ring split
    over the model axis) is laid out by no config: ``attn_decode`` raises,
    naming it, before it computes anything."""
    from repro_torch.models import attention, parallel

    class _Mesh:
        mesh_dim_names = ("model",)

        def size(self, i=None):
            return 2

    acfg = tt.ModelConfig(**BASE, dtype=torch.float32).attn_cfg(window=8)
    K = torch.zeros(2, 4, 2, 16)
    parallel.tag(K, parallel.Layout((None, "model", None, None), _Mesh(),
                                    (2, 8, 2, 16)))
    p = attention.attn_init(torch.Generator().manual_seed(0), acfg,
                            dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        attention.attn_decode(p, acfg, torch.zeros(2, 1, 64),
                              {"k": K, "v": K.clone(),
                               "idx": torch.tensor(3)})
