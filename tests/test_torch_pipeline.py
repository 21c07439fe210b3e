"""Port parity: data pipeline, recipes, calibration and ``quantize_model``.

Tolerances and their sources:
  * TokenStream batches: byte-identical (both draw with numpy);
  * calibration Grams: rtol 1e-4 (f32 forward, another summation order);
  * quantize_model(engine="sequential") against the JAX engine (the
    port's health guards on, the reference's off): codes >= 99.9% equal over the model and Qd within
    atol 2e-4 (``tests/test_distributed.py:89-90``) wherever the codes
    agree; scales within rtol 1e-6 (MagR ran on Grams that differ in the
    last bits), zero points equal.  A code differs only where OPTQ's pre-round value lands within
    f32 noise of a rounding boundary (seen: 3.4999876 against the
    boundary 3.49999); the error feedback then carries the flip down the
    rest of that column, so a differing code moves Qd by a whole grid
    step and the count is bounded per site (>= 98%: a few columns).  The
    CLoQ product ``A @ B^T`` is held to a relative Frobenius error of 1e-3
    against JAX's: on a site whose codes all agree, JAX's own factors; on a
    site with a flipped column, JAX's ``cloq_init`` solved on the port's
    residual W - Qd (the residual itself differs there by grid steps).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import cloq as jc
from repro.core import pipeline as jp
from repro.core import recipe as jr
from repro.core.health import HealthPolicy
from repro.core.quantizer import dequantize_int, unpack_codes
from repro.data import DataConfig as JDC
from repro.data import TokenStream as JTS
from repro.models import modules as jmod
from repro.models import transformer as jt
from repro.utils import get_path
from repro.utils import tree_paths as jpaths
from repro_torch import convert
from repro_torch.core import pipeline as tp
from repro_torch.core import recipe as tr
from repro_torch.data import DataConfig as TDC
from repro_torch.data import TokenStream as TTS
from repro_torch.models import modules as tmod
from repro_torch.utils import tree_paths as tpaths
from tests.torch_parity import configs, jax_to_numpy, port_params, to_np


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_token_stream_byte_identical(seed, step):
    kw = dict(vocab=512, seq_len=24, global_batch=3, seed=seed)
    js, ts = JTS(JDC(**kw), step=step), TTS(TDC(**kw), step=step)
    for _ in range(2):
        bj, bt = js.next_batch(), ts.next_batch()
        for k in ("tokens", "labels"):
            a, b = np.asarray(bj[k]), bt[k].numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ts.state_dict() == js.state_dict()


def test_recipe_resolution_and_json():
    rules = (dict(pattern="blocks.0.*", skip=True),
             dict(pattern="*.mlp.*", bits=2, rank=16),
             dict(pattern=r"attn\.(q|k)$", regex=True, split="sqrt"))
    rj = jr.QuantRecipe(rules=rules, qspec=jmod.QSpec(bits=4, rank=8))
    rt = tr.QuantRecipe(rules=rules, qspec=tmod.QSpec(bits=4, rank=8))
    paths = ["blocks.0.attn.q", "blocks.1.mlp.up", "blocks.1.attn.k",
             "blocks.1.attn.o"]
    for p in paths:
        sj, st = rj.resolve_one(p), rt.resolve_one(p)
        assert (sj.method, sj.skip) == (st.method, st.skip)
        assert dataclasses.asdict(sj.qspec) == dataclasses.asdict(st.qspec)
    assert rt.to_dict() == rj.to_dict()
    assert tr.QuantRecipe.from_dict(json.loads(json.dumps(rt.to_dict()))) \
        == rt
    with pytest.raises(ValueError):
        tr.QuantRecipe(method="bogus")


def test_load_plan_from_manifest(tmp_path):
    rec = tr.QuantRecipe(rules=(tr.SiteRule("*.mlp.*", bits=2),))
    (tmp_path / "m.json").write_text(json.dumps({"buckets": [],
                                                 "recipe": rec.to_dict()}))
    (tmp_path / "r.json").write_text(json.dumps(rec.to_dict()))
    assert tr.load_plan(str(tmp_path / "m.json")) == rec
    assert tr.load_plan(str(tmp_path / "r.json")) == rec


def _model(seed=0, **cfg_kw):
    cfg_j, cfg_t = configs(**cfg_kw)
    pj = jt.init_params(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, port_params(pj, cfg_t)


def test_layouts_and_paths():
    cfg_j, cfg_t, pj, pt = _model()
    ej = jp.to_eager_params(pj, cfg_j)
    et = tp.to_eager_params(pt, cfg_t)
    assert tp.quantizable_linear_paths(et) == jp.quantizable_linear_paths(ej)
    back = tp.to_scan_params(et, cfg_t)
    for path, leaf in tpaths(pt).items():
        assert torch.equal(tpaths(back)[path], leaf)


def test_convert_bf16_exact():
    a = np.random.default_rng(0).normal(size=(4, 6)).astype(ml_dtypes.bfloat16)
    cfg_j, cfg_t = configs()
    tree = {"embed": {"w": a}, "blocks": {"0": {"x": {"w": a}}}}
    out = convert.params_from_jax(tree, dataclasses.replace(
        cfg_t, scan_layers=False), device="cpu")
    assert out["embed"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["embed"]["w"].view(torch.int16).numpy(),
                                  a.view(np.int16))
    stacked = convert.params_from_jax(tree, cfg_t, device="cpu")
    assert tuple(stacked["blocks"]["x"]["w"].shape) == (1, 4, 6)


def test_convert_device_defaults_to_cuda(monkeypatch):
    """Without a device the carry resolves to CUDA and raises on a host
    without it; ``device="cpu"`` builds on the CPU."""
    a = np.ones((2, 3), np.float32)
    tree = {"embed": {"w": a}, "blocks": {"0": {"x": {"w": a}}}}
    _, cfg_t = configs()
    cfg_t = dataclasses.replace(cfg_t, scan_layers=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(tree, cfg_t)
    out = convert.params_from_jax(tree, cfg_t, device="cpu")
    assert out["embed"]["w"].device.type == "cpu"


def _calib(vocab, seed=0):
    kw = dict(vocab=vocab, seq_len=32, global_batch=2, seed=seed)
    return [JTS(JDC(**kw)).next_batch()], [TTS(TDC(**kw)).next_batch()]


def test_run_calibration_grams():
    cfg_j, cfg_t, pj, pt = _model(seed=2)
    cj, ct = _calib(cfg_j.vocab, seed=1)
    sj = jp.run_calibration(jp.to_eager_params(pj, cfg_j), cfg_j, cj)
    st = tp.run_calibration(pt, cfg_t, ct)
    assert st.paths() == sj.paths() and len(st.paths()) == 14
    for p in sj.paths():
        hj, ht = sj.gram(p), to_np(st.gram(p))
        np.testing.assert_allclose(ht, hj, rtol=1e-4,
                                   atol=1e-4 * np.abs(hj).max())
        assert st.counts[p] == sj.counts[p]


def test_gram_store_goes_through_the_gram_wrapper(monkeypatch):
    """``GramStore.add`` hands x to ``ops.gram`` in its own dtype (the CUDA
    kernel upcasts inside) and sums what it returns; on the CPU that is
    the plain version, equal to the JAX store's f32 ``x2.T @ x2``."""
    from repro.utils import GramStore as JStore
    from repro_torch.kernels import ops
    from repro_torch.utils import GramStore as TStore
    seen = []
    real = ops.gram

    def spy(x):
        seen.append(x.dtype)
        return real(x)

    monkeypatch.setattr(ops, "gram", spy)
    xs = [np.random.default_rng(i).normal(size=(2, 7, 24)).astype(np.float32)
          for i in range(2)]
    js, ts = JStore(), TStore()
    for x in xs:
        js.add("a", jnp.asarray(x))
        ts.add("a", torch.from_numpy(x).to(torch.bfloat16))
    assert seen == [torch.bfloat16] * 2 and ts.counts["a"] == 28
    jb = JStore()
    for x in xs:
        jb.add("a", jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(to_np(ts.gram("a")), np.asarray(jb.gram("a")),
                               rtol=1e-5, atol=1e-5)
    assert js.counts["a"] == ts.counts["a"]


def _qd(leaf: dict, m: int) -> np.ndarray:
    bits = jmod.packed_bits(leaf["qcodes"].shape[-2], m)
    g = m // leaf["scales"].shape[-2]
    return np.asarray(dequantize_int(
        unpack_codes(jnp.asarray(leaf["qcodes"]), bits, m),
        jnp.asarray(leaf["scales"]), jnp.asarray(leaf["zeros"]), g))


def test_quantize_model_sequential_matches_jax():
    cfg_j, cfg_t, pj, pt = _model(seed=3)
    cj, ct = _calib(cfg_j.vocab, seed=2)
    qspec = dict(bits=4, group_size=16, rank=8)
    ej = jp.to_eager_params(pj, cfg_j)
    qj, cfgq_j, store_j = jp.quantize_model(
        pj, cfg_j, cj, recipe=jr.QuantRecipe.single(
            "cloq", jmod.QSpec(**qspec)),
        engine="sequential", policy=HealthPolicy(enabled=False))
    qt, cfgq_t, store = tp.quantize_model(
        pt, cfg_t, ct, recipe=tr.QuantRecipe.single(
            "cloq", tmod.QSpec(**qspec)), engine="sequential")
    assert dataclasses.asdict(cfgq_t.quant) == dataclasses.asdict(
        cfgq_j.quant)
    lj, lt = jpaths(jax_to_numpy(qj)), {k: to_np(v) for k, v in
                                        tpaths(qt).items()}
    assert sorted(lj) == sorted(lt)
    sites = sorted({p.rsplit(".", 1)[0] for p in lj if p.endswith("qcodes")})
    assert len(sites) == 7
    n_codes = n_same = 0
    for site in sites:
        leaves_j = {k: lj[f"{site}.{k}"] for k in
                    ("qcodes", "scales", "zeros", "lora_a", "lora_b")}
        leaves_t = {k: lt[f"{site}.{k}"] for k in leaves_j}
        assert tpaths(qt)[f"{site}.qcodes"].dtype == torch.uint8
        for layer in range(cfg_t.n_layers):
            lj1 = {k: v[layer] for k, v in leaves_j.items()}
            lt1 = {k: v[layer] for k, v in leaves_t.items()}
            m = lj1["lora_a"].shape[0]
            codes_j = np.asarray(unpack_codes(jnp.asarray(lj1["qcodes"]), 4,
                                              m))
            codes_t = np.asarray(unpack_codes(jnp.asarray(lt1["qcodes"]), 4,
                                              m))
            same = codes_j == codes_t
            n_codes += same.size
            n_same += int(same.sum())
            assert same.mean() >= 0.98, (site, layer, same.mean())
            np.testing.assert_allclose(lt1["scales"], lj1["scales"],
                                       rtol=1e-6)
            np.testing.assert_array_equal(lt1["zeros"], lj1["zeros"])
            np.testing.assert_allclose(_qd(lt1, m)[same], _qd(lj1, m)[same],
                                       atol=2e-4)
            abt = lt1["lora_a"] @ lt1["lora_b"].T
            if same.all():
                abj = lj1["lora_a"] @ lj1["lora_b"].T
            else:       # the JAX solve on the port's own residual W - Qd
                _, mod, lin = site.split(".")
                path = f"blocks.{layer}.{mod}.{lin}"
                W = np.asarray(get_path(ej, path)["w"], np.float32)
                A, B = jc.cloq_init(jc.regularize_gram(jnp.asarray(
                    store_j.gram(path))), jnp.asarray(W - _qd(lt1, m)), 8)
                abj = np.asarray(A @ B.T)
            rel = np.linalg.norm(abt - abj) / np.linalg.norm(abj)
            assert rel <= 1e-3, (site, layer, rel)
    assert n_same / n_codes >= 0.999, n_same / n_codes
    for path in ("embed.w", "head.w", "final_norm.scale", "blocks.ln1.scale"):
        np.testing.assert_array_equal(lt[path], lj[path])


def test_quantize_model_rejects_unported(tmp_path, monkeypatch):
    """What the engines cannot do raises before calibration: the mesh, the
    cost model and a journal need the batched engine, as in the JAX twin.
    The compile cache is ported: ``compile_cache`` names the kernel
    libraries' directory (none is loaded on the CPU).  A recipe that skips
    every site leaves the model dense."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_cache", None)
    cfg_j, cfg_t, pj, pt = _model()
    _, ct = _calib(cfg_t.vocab)
    for kw in (dict(mesh=object()), dict(cost_model="auto")):
        with pytest.raises(ValueError, match="batched"):
            tp.quantize_model(pt, cfg_t, ct, engine="sequential", **kw)
    with pytest.raises(ValueError, match="batched"):
        tp.quantize_model(pt, cfg_t, ct, engine="sequential",
                          journal_dir="j")
    with pytest.raises(ValueError, match="engine"):
        tp.quantize_model(pt, cfg_t, ct, engine="bogus")
    skip_all = tr.QuantRecipe(rules=(tr.SiteRule("*", skip=True),))
    qt, _, _ = tp.quantize_model(pt, cfg_t, ct, recipe=skip_all,
                                 compile_cache=str(tmp_path / "cache"))
    assert not any(p.endswith("qcodes") for p in tpaths(qt))
    assert build.active_cache().directory == tmp_path / "cache"
    assert build.active_cache().summary() == "cache hits=0 misses=0"


def test_stacked_expert_sites_are_quantization_sites():
    """Stacked MoE expert weights (E, m, n) are quantization sites like the
    2-D linears (the router is not), as are a hybrid's weight-shared
    linears and an enc-dec model's cross-attention linears, each read at
    the reference's capture scope."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config("olmoe-1b-7b", scan_layers=False)
    params = init_params(cfg, seed=0, device="cpu")
    paths = tp.quantizable_linear_paths(params)
    assert len(paths) == 2 * (4 + 3)
    assert "blocks.1.moe.down" in paths and not any("router" in p
                                                    for p in paths)
    assert get_path(params, "blocks.1.moe.down")["w"].dim() == 3
    encdec = init_params(get_smoke_config("seamless-m4t-medium",
                                          scan_layers=False),
                         seed=0, device="cpu")
    cross = [p for p in tp.quantizable_linear_paths(encdec)
             if p.startswith("cross.")]
    assert cross == [f"cross.{i}.xattn.{n}" for i in range(2)
                     for n in ("k", "o", "q", "v")]
    for p in paths + cross + ["shared.block.attn.q"]:
        assert tp._scope_for(p) == jp._scope_for(p)
    assert tp._scope_for("cross.1.xattn.v") == "dec_blocks.1.cross.v"


@pytest.mark.parametrize("case", ["normal", "huge", "overflow", "nan"])
def test_activation_log_merges_as_a_scratch_store(case):
    """Calibration records a batch's activations and adds its Grams one at
    a time: the store ends bit-equal to merging a per-batch scratch
    ``GramStore`` (a path recorded twice, an expert buffer), and the
    batch counts as finite exactly when every scratch Gram is: huge but
    finite activations (past the size bound, so the Grams are computed),
    activations whose Gram overflows f32, a NaN."""
    from repro_torch.utils import ActivationLog, GramStore
    rng = np.random.default_rng(11)
    xs = [("a", rng.normal(size=(2, 5, 8)), False),
          ("e", rng.normal(size=(3, 4, 8)), True),
          ("a", rng.normal(size=(10, 8)), False)]
    scale = {"normal": 1.0, "huge": 1e18, "overflow": 1e20,
             "nan": 1.0}[case]
    recs = [(p, torch.from_numpy(x.astype(np.float32)) * scale, k)
            for p, x, k in xs]
    if case == "nan":
        recs[1][1][0, 0, 0] = float("nan")
    scratch, log = GramStore(), ActivationLog()
    for p, x, k in recs:
        scratch.add(p, x, keep_leading=k)
        log.add(p, x, keep_leading=k)
    assert log.grams_finite() == scratch.all_finite() == \
        (case in ("normal", "huge"))
    base = GramStore()
    base.add("a", torch.ones(3, 8))
    want, got = GramStore(), GramStore()
    for s in (want, got):
        s.merge(base)
    want.merge(scratch)
    log.merge_into(got)
    assert want.counts == got.counts == {"a": 23, "e": 4}
    for p in want.grams:
        torch.testing.assert_close(got.grams[p], want.grams[p], rtol=0,
                                   atol=0, equal_nan=True)
