"""Port parity: the distributed quantization engine on a 2-rank model mesh.

The port's ranks (2 gloo processes on the CPU, ``repro_torch.launch.mesh.
spawn_ranks``, bodies in ``tests/torch_dist_worker.py``) run once for the
whole file; the JAX package's sharded engine runs once in a subprocess
over 2 fake devices (as ``tests/util.py`` ``run_with_devices`` runs it,
beside the ranks), the setting
of ``tests/test_batched_sharded.py``.  Leaves are held to the reference's
engine oracle (``tests/util.py`` ``assert_leaves_close``: codes flip at
most 0.005 of a site, float leaves within 1e-3 relative, ``A @ B^T``
within 5e-3).  The per-layer sharded wrappers are held against JAX's
*unsharded* functions: the JAX package's own per-layer sharded test
(``tests/test_distributed.py``) fails inside the installed JAX's
``shard_map`` before it computes anything.
"""
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

from repro.core import cloq as jcloq
from repro.core import loftq as jloftq
from repro.core import optq as jopt
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import transformer as jt
from repro_torch import configs as tc
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import cloq as tcloq
from repro_torch.core import loftq as tloftq
from repro_torch.core import pipeline as tp
from repro_torch.core.recipe import QuantRecipe
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.utils import tree_paths as tpaths
from tests import torch_dist_worker
from tests.torch_parity import (configs, port_params, to_np,
                                worker_threads)
from tests.util import SRC, assert_leaves_close, lora_product, rel_fro

METHODS = torch_dist_worker.METHODS
QS = dict(bits=2, group_size=16, rank=8)
MODEL_QS = dict(bits=4, group_size=16, rank=8)
LORA_REL = 5e-3


def _layers(n_layers, m, n, seed=0):
    """``tests/test_batched_sharded.py``'s bucket: W ~ N(0, 1), H = X^T X
    over 256 rows."""
    rng = np.random.default_rng(seed)
    Ws = [rng.normal(size=(m, n)).astype(np.float32)
          for _ in range(n_layers)]
    Hs = []
    for _ in range(n_layers):
        X = rng.normal(size=(256, m)).astype(np.float32)
        Hs.append(X.T @ X)
    return Ws, Hs


def _factor_inputs():
    rng = np.random.default_rng(5)
    m, n, S = 32, 48, 5
    X = rng.normal(size=(128, m)).astype(np.float32)
    Xs = rng.normal(size=(S, 128, m)).astype(np.float32)
    return {"dW": rng.normal(size=(m, n)).astype(np.float32),
            "W": rng.normal(size=(m, n)).astype(np.float32),
            "H": X.T @ X, "Hs_site": np.einsum("stm,stn->smn", Xs, Xs)}


def _moe_cfgs():
    """``tests/test_batched_sharded.py::test_sharded_model_parity_moe``'s
    model."""
    base = dict(name="t", family="moe", n_layers=2, d_model=32, vocab=128,
                n_heads=4, n_kv_heads=2, n_experts=4, top_k=2,
                d_ff_expert=32)
    return (jt.ModelConfig(**base, dtype=jnp.float32),
            tt.ModelConfig(**base, dtype=torch.float32))


def _calib(vocab, seed):
    from repro_torch.data import DataConfig, TokenStream
    return [TokenStream(DataConfig(vocab=vocab, seq_len=32, global_batch=2,
                                   seed=seed)).next_batch()]


_JAX_REF = """
    import pickle
    from repro.core.batched import LayerTask, plan_buckets, quantize_layer_batch
    from repro.core.cloq import cloq_site_lora
    from repro.core.pipeline import quantize_model, to_eager_params
    from repro.core.recipe import QuantRecipe
    from repro.data import DataConfig, TokenStream
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_model_mesh
    from repro.models.modules import QSpec
    from repro.models.transformer import ModelConfig, init_params
    from repro.utils import tree_paths

    inp = pickle.load(open({inp!r}, "rb"))
    mesh = make_model_mesh()
    assert mesh.shape["model"] == 2
    out = {{}}
    qspec = QSpec(**inp["qs"])
    keys = jax.random.split(jax.random.PRNGKey(0), len(inp["Ws"]))
    tasks = [LayerTask(f"l{{i}}", None, jnp.asarray(W), jnp.asarray(H), k)
             for i, (W, H, k) in enumerate(zip(inp["Ws"], inp["Hs"], keys))]
    for method in {methods!r}:
        spec = next(iter(plan_buckets(tasks, qspec, method, mesh=mesh)))
        got = quantize_layer_batch(tasks, qspec, method, mesh=mesh)
        out["bucket." + method] = {{
            "n_shards": spec.n_shards,
            "leaves": [{{k: np.asarray(v) for k, v in g.items()}}
                       for g in got]}}
    As, Bs = cloq_site_lora(jnp.asarray(inp["Hs_site"]),
                            jnp.asarray(inp["dW"]), 8, mesh=mesh)
    out["site_lora"] = {{"As": np.asarray(As), "Bs": np.asarray(Bs)}}
    recipe = QuantRecipe.single("cloq", QSpec(**inp["model_qs"]))
    models = {{"dense": (get_smoke_config("qwen3-1.7b"), 3, 2),
               "moe": (ModelConfig(**inp["moe_base"], dtype=jnp.float32),
                       0, 3)}}
    for name, (cfg, pseed, dseed) in models.items():
        params = init_params(jax.random.PRNGKey(pseed), cfg)
        calib = [TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=2,
                                        seed=dseed)).next_batch()]
        qp, qcfg, _ = quantize_model(params, cfg, calib, recipe=recipe,
                                     engine="batched", mesh=mesh)
        out["model." + name] = {{
            k: np.asarray(v)
            for k, v in tree_paths(to_eager_params(qp, qcfg)).items()}}
    with open({out!r}, "wb") as f:
        pickle.dump(out, f)
    print("jax reference written")
"""


def _start_with_devices(code: str, n_devices: int) -> subprocess.Popen:
    """``tests/util.py`` ``run_with_devices``'s subprocess, started and not
    waited for."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                        f"platform_device_count={n_devices}").strip()
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results: ``(port, jax)`` dicts of numpy data."""
    work = tmp_path_factory.mktemp("dist")
    Ws, Hs = _layers(4, 32, 48)
    Ws45, Hs45 = _layers(4, 32, 45)
    fac = _factor_inputs()
    cfg_j, cfg_t = configs()
    pj = jt.init_params(jax.random.PRNGKey(3), cfg_j)
    mj, mt = _moe_cfgs()
    pm = jt.init_params(jax.random.PRNGKey(0), mj)
    inp = {"qs": QS, "model_qs": MODEL_QS, "Ws": Ws, "Hs": Hs,
           "Ws45": Ws45, "Hs45": Hs45, **fac,
           "dense.cfg": cfg_t, "dense.params": port_params(pj, cfg_t),
           "dense.calib": _calib(cfg_t.vocab, 2),
           "moe.cfg": mt, "moe.params": port_params(pm, mt),
           "moe.calib": _calib(128, 3), "budget": 60_000}
    hcfg = tc.get_smoke_config("zamba2-7b")
    inp.update({"hybrid.cfg": hcfg, "hybrid.calib": _calib(hcfg.vocab, 4),
                "hybrid.params": tt.init_params(hcfg, seed=0,
                                                device="cpu")})
    with open(work / "inputs.pt", "wb") as f:
        torch.save(inp, f)
    jinp = {"qs": QS, "model_qs": MODEL_QS, "Ws": Ws, "Hs": Hs, **fac,
            "moe_base": dict(name="t", family="moe", n_layers=2, d_model=32,
                             vocab=128, n_heads=4, n_kv_heads=2,
                             n_experts=4, top_k=2, d_ff_expert=32)}
    with open(work / "jax_in.pkl", "wb") as f:
        pickle.dump(jinp, f)
    # the JAX reference runs beside the port's ranks
    jax_proc = _start_with_devices(
        "import jax, jax.numpy as jnp, numpy as np\n"
        + textwrap.dedent(_JAX_REF).format(
            inp=str(work / "jax_in.pkl"), out=str(work / "jax_out.pkl"),
            methods=METHODS), n_devices=2)
    try:
        tmesh.spawn_ranks(torch_dist_worker.run, 2, backend="gloo",
                          device="cpu", args=(str(work),),
                          threads=max(1, worker_threads() // 2),
                          store_dir=str(work))
    finally:
        stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, f"JAX reference failed:\n{stderr}"
    with open(work / "outputs.pkl", "rb") as f:
        port = pickle.load(f)
    with open(work / "jax_out.pkl", "rb") as f:
        ref = pickle.load(f)
    return port, ref, work


def _sign_align(U, U0):
    """``U``'s columns flipped to ``U0``'s signs (an eigenvector's sign is
    free)."""
    s = np.sign(np.sum(U * U0, axis=0))
    return U * np.where(s == 0, 1.0, s)


def test_gram_trick_cores_match_jax_and_the_group(runs):
    """``svd_lowrank_topr`` and ``cloq_lowrank_local`` without a group
    against JAX's with ``axis=None`` (``U``, ``S`` within 1e-4 up to the
    eigenvectors' signs, ``A @ B^T`` within 5e-3), ``loftq_init`` with and
    without ``gram_trick`` against JAX's, and over the 2-rank group the
    same as without one."""
    port, _, _ = runs
    fac = _factor_inputs()
    dW = fac["dW"]
    U, S, V = tloftq.svd_lowrank_topr(torch.from_numpy(dW), 8)
    Uj, Sj, Vj = jloftq.svd_lowrank_topr(jnp.asarray(dW), 8)
    Uj, Sj = np.asarray(Uj), np.asarray(Sj)
    np.testing.assert_allclose(to_np(S), Sj, rtol=1e-4)
    np.testing.assert_allclose(_sign_align(to_np(U), Uj), Uj, atol=1e-4)
    assert rel_fro((to_np(U) * to_np(S)) @ to_np(V).T,
                   (Uj * Sj) @ np.asarray(Vj).T) <= 1e-4
    Hreg = jcloq.regularize_gram(jnp.asarray(fac["H"]))
    R, Rinv = jcloq.gram_root(Hreg)
    Aj, Bj = jcloq.cloq_lowrank_local(R, Rinv, jnp.asarray(dW), 8)
    Rt, Rinvt = tcloq.gram_root(tcloq.regularize_gram(
        torch.from_numpy(fac["H"])))
    A, B = tcloq.cloq_lowrank_local(Rt, Rinvt, torch.from_numpy(dW), 8)
    assert rel_fro(lora_product(to_np(A), to_np(B)),
                   lora_product(Aj, Bj)) <= LORA_REL
    # LoftQ with every round's factors through the Gram trick on all
    # columns: the sharded run's factorization, unsharded
    from repro.core.quantizer import QuantConfig as JQC
    from repro_torch.core.quantizer import QuantConfig as TQC
    W = fac["W"] * 0.1
    Qj, Aj, Bj, _ = jloftq.loftq_init(jnp.asarray(W), JQC(bits=4,
                                                         group_size=16), 8)
    for gt in (False, True):
        Qt, At, Bt, _ = tloftq.loftq_init(torch.from_numpy(W),
                                          TQC(bits=4, group_size=16), 8,
                                          gram_trick=gt)
        assert rel_fro(to_np(Qt), np.asarray(Qj)) <= 1e-3
        assert rel_fro(lora_product(to_np(At), to_np(Bt)),
                       lora_product(Aj, Bj)) <= LORA_REL
    t = port["topr"]
    np.testing.assert_allclose(t["S"], t["S0"], rtol=1e-4)
    np.testing.assert_allclose(t["U"], t["U0"], atol=1e-5)
    np.testing.assert_allclose(t["V"], t["V0"], atol=1e-5)
    lr = port["lowrank"]
    assert rel_fro(lora_product(lr["A"], lr["B"]),
                   lora_product(lr["A0"], lr["B0"])) <= 1e-5


@pytest.mark.parametrize("method", METHODS)
def test_sharded_bucket_matches_jax_sharded_bucket(runs, method):
    """``quantize_layer_batch(mesh=)`` plans the n = 48 bucket on 2
    shards, each rank holding 24 columns, its progress line says
    ``path=sharded shards=2``, and every task's gathered leaves are within
    the oracle of JAX's sharded engine and of the port's unsharded one
    (random ``A`` bit-equal to the unsharded engine's: checked in the
    ranks)."""
    port, ref, _ = runs
    got, want = port[f"bucket.{method}"], ref[f"bucket.{method}"]
    assert got["n_shards"] == want["n_shards"] == 2
    assert got["local_cols"] == 24
    assert "path=sharded shards=2" in got["lines"][0]
    for g, w, u in zip(got["leaves"], want["leaves"], got["unsharded"]):
        assert_leaves_close(g, w, lora_rel=LORA_REL)
        assert_leaves_close(g, u, lora_rel=LORA_REL)


def test_per_layer_sharded_dispatch_matches_the_bucket(runs):
    """The per-layer baseline (one sharded OPTQ call and one sharded CLoQ
    solve a layer) gives each layer the sharded bucket's ``A @ B^T``
    within 5e-3; a ``("data", "model")`` mesh of 1 x 2 ranks names its
    axes as the JAX twin's, and its parallel context takes "data"."""
    port, _, _ = runs
    for pl, lv in zip(port["per_layer"], port["bucket.cloq"]["leaves"]):
        assert rel_fro(lora_product(pl["lora_a"], pl["lora_b"]),
                       lora_product(lv["lora_a"], lv["lora_b"])) <= LORA_REL
    assert port["local_mesh"] == {"names": ["data", "model"],
                                  "sizes": [1, 2], "data_axes": ["data"],
                                  "pctx_data": "data",
                                  "pctx_model": "model"}


def test_non_divisible_bucket_stays_replicated(runs):
    """n = 45 does not divide 2: one shard, plain tensors, the no-mesh
    leaves bit for bit."""
    port, _, _ = runs
    assert port["bucket45"] == {"n_shards": 1, "equal": True}


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_model_matches_sequential_and_jax(runs, name):
    """``quantize_model(mesh=)`` on the dense smoke model and the MoE model
    (its expert bucket stacked): every site within the oracle of the
    port's sequential engine and of JAX's sharded engine; some bucket ran
    ``path=sharded shards=2``."""
    port, ref, work = runs
    out = port[f"model.{name}"]
    assert any("path=sharded shards=2" in ln for ln in out["lines"])
    inp = torch.load(work / "inputs.pt", weights_only=False)
    recipe = QuantRecipe.single("cloq", TQSpec(**MODEL_QS))
    qs, qcfg, _ = tp.quantize_model(inp[f"{name}.params"], inp[f"{name}.cfg"],
                                    inp[f"{name}.calib"], recipe=recipe,
                                    engine="sequential")
    seq = {k: to_np(v) for k, v in
           tpaths(tp.to_eager_params(qs, qcfg)).items()}
    got, jax_out = out["leaves"], ref[f"model.{name}"]
    assert sorted(got) == sorted(seq) == sorted(jax_out)
    sites = sorted({p.rsplit(".", 1)[0] for p in got if p.endswith("qcodes")})
    assert sites
    for site in sites:
        keys = [k for k in ("qcodes", "scales", "zeros", "lora_a", "lora_b")
                if f"{site}.{k}" in got]
        g = {k: got[f"{site}.{k}"] for k in keys}
        for other in (seq, jax_out):
            w = {k: other[f"{site}.{k}"] for k in keys}
            if g["qcodes"].ndim == 3:            # a stacked expert site
                for e in range(g["qcodes"].shape[0]):
                    assert_leaves_close({k: v[e] for k, v in g.items()},
                                        {k: v[e] for k, v in w.items()},
                                        lora_rel=LORA_REL)
            else:
                assert_leaves_close(g, w, lora_rel=LORA_REL)


def test_sharded_shared_block_sites_match_sequential(runs):
    """``quantize_model(mesh=)`` on the hybrid smoke model: the weight-
    shared block's base and each call site's CLoQ adapters (solved
    column-sharded against the site's own Gram, ``cloq_site_lora(mesh=)``)
    within the oracle of the port's sequential engine, site by site."""
    port, _, work = runs
    out = port["model.hybrid"]
    assert any("path=sharded shards=2" in ln for ln in out["lines"])
    inp = torch.load(work / "inputs.pt", weights_only=False)
    recipe = QuantRecipe.single("cloq", TQSpec(**MODEL_QS))
    qs, qcfg, _ = tp.quantize_model(inp["hybrid.params"], inp["hybrid.cfg"],
                                    inp["hybrid.calib"], recipe=recipe,
                                    engine="sequential")
    seq = {k: to_np(v) for k, v in
           tpaths(tp.to_eager_params(qs, qcfg)).items()}
    got = out["leaves"]
    assert sorted(got) == sorted(seq)
    stacks = sorted({p.rsplit(".", 1)[0] for p in got
                     if p.startswith("shared.site_lora.")})
    assert stacks
    for st in stacks:
        g, w = (lora_product(t[f"{st}.lora_a"], t[f"{st}.lora_b"])
                for t in (got, seq))
        assert g.shape[0] >= 2
        for i in range(g.shape[0]):
            assert rel_fro(g[i], w[i]) <= LORA_REL, (st, i)
    for site in sorted({p.rsplit(".", 1)[0] for p in got
                        if p.endswith("qcodes")}):
        keys = [k for k in ("qcodes", "scales", "zeros", "lora_a", "lora_b")
                if f"{site}.{k}" in got]
        assert_leaves_close({k: got[f"{site}.{k}"] for k in keys},
                            {k: seq[f"{site}.{k}"] for k in keys},
                            lora_rel=LORA_REL)


def test_sequential_engine_rejects_mesh():
    """As in the JAX twin: a mesh needs the batched engine, refused
    before calibration."""
    _, cfg = configs()
    params = tt.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        tp.quantize_model(params, cfg, [], engine="sequential",
                          mesh=object())


def test_sharded_site_lora_matches_unsharded_and_jax(runs):
    """``cloq_site_lora(mesh=)``: each site's ``A @ B^T`` within 5e-3 of
    the port's unsharded solve and of JAX's sharded one."""
    port, ref, _ = runs
    fac = _factor_inputs()
    A0, B0 = tcloq.cloq_site_lora(torch.from_numpy(fac["Hs_site"]),
                                  torch.from_numpy(fac["dW"]), 8)
    got = lora_product(port["site_lora"]["As"], port["site_lora"]["Bs"])
    assert got.shape == (5, 32, 48)
    assert rel_fro(got, lora_product(to_np(A0), to_np(B0))) <= LORA_REL
    assert rel_fro(got, lora_product(ref["site_lora"]["As"],
                                     ref["site_lora"]["Bs"])) <= LORA_REL


def test_per_layer_sharded_wrappers_match_jax_unsharded(runs):
    """``optq_quantize_sharded`` against JAX's unsharded ``optq_quantize``
    (codes flip at most 0.005, the rest within 1e-3) and
    ``cloq_init_sharded`` against JAX's ``cloq_init`` (``A @ B^T`` within
    5e-3)."""
    port, _, _ = runs
    fac = _factor_inputs()
    Qd, codes, s, z = jopt.optq_quantize(jnp.asarray(fac["W"]),
                                         jnp.asarray(fac["H"]),
                                         JQuantConfig(bits=4, group_size=16))
    gQd, gcodes, gs, gz = port["optq"]
    assert float(np.mean(gcodes != np.asarray(codes))) <= 0.005
    for g, w in ((gQd, Qd), (gs, s), (gz, z)):
        assert rel_fro(g, np.asarray(w)) <= 1e-3
    Aj, Bj = jcloq.cloq_init(jcloq.regularize_gram(jnp.asarray(fac["H"])),
                             jnp.asarray(fac["dW"]), 8)
    c = port["cloq_init"]
    assert rel_fro(lora_product(c["A"], c["B"]),
                   lora_product(Aj, Bj)) <= LORA_REL


def test_sharded_sweep_and_allocation(runs):
    """``evaluate_layer_batch(mesh=)``: every error within 1e-3 of the
    unsharded sweep's, the divisible buckets sharded; ``allocate_plan
    (mesh=)`` picks the unsharded plan."""
    port, _, _ = runs
    sw = port["sweep"]
    assert all("path=sharded shards=2" in ln for ln in sw["lines"])
    for e, r in zip(sw["errs"], sw["ref"]):
        assert abs(e - r) <= 1e-3 * abs(r), (e, r)
    assert sw["recipes"][0] == sw["recipes"][1]
    assert abs(sw["errors"][0] - sw["errors"][1]) <= \
        1e-3 * abs(sw["errors"][1])


def test_sharded_checkpoint_restores_sharded_and_whole(runs):
    """The sharded CLoQ tree saved with its manifest (gathered, written by
    rank 0): ``restore_tree(mesh=)`` gave each rank its own blocks with
    equal bits (checked in the ranks), and restored whole here it equals
    the gathered tree bit for bit; the manifest records the sharded
    buckets."""
    port, _, work = runs
    r = port["restore.dense"]
    assert r["sharded_leaves"] > 0
    assert any(b["spec"]["n_shards"] == 2 for b in r["manifest"]["buckets"])
    tree, meta = ckpt.restore_tree(str(work / "ckpt"))
    assert meta[ckpt.MANIFEST_KEY] == r["manifest"]
    inp = torch.load(work / "inputs.pt", weights_only=False)
    flat = {k: to_np(v) for k, v in tpaths(
        tp.to_eager_params(tree, inp["dense.cfg"])).items()}
    want = port["model.dense"]["leaves"]
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_allreduce_count_and_misuse(runs):
    """The ranks' collectives went through the counted all-reduce;
    ``calibrate(mesh)`` timed the all-reduce over the ranks' group, gave
    every rank rank 0's table and wrote it once; a mesh without a process
    group, or on CUDA where there is none, raises."""
    from repro_torch.core import costmodel as tcm
    port, _, work = runs
    assert port["allreduce"]["calls"] > 0
    assert port["allreduce"]["bytes"] > 0
    cal = port["calibration"]
    assert cal["n_devices"] == 2 and cal["source"] == "measured"
    assert cal["psum_latency_s"] > 0 and cal["psum_bytes_per_s"] > 0
    assert 0.0 < cal["shard_efficiency"] <= 2.0
    saved = tcm.load_calibration(str(work / "cal.json"))
    assert saved.flops_per_s == cal["flops_per_s"]
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_model_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_model_mesh(2)
