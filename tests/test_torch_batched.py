"""Port parity: the batched quantization engine (``repro_torch.core.
batched``) against its sequential oracle and against the JAX package.

Mirrors the dense tests of ``tests/test_batched.py`` with the reference's
own batched-vs-sequential oracle: codes equal up to a flip fraction of
0.005, float leaves within 1e-3 relative Frobenius, ``(lora_a, lora_b)``
through their product ``A @ B^T`` within 1e-3, and the calibrated
objective ``gram_error`` of the whole init within 1e-3 relative.  The
port is held to it twice: its batched engine against its own sequential
one (where the random ``A`` of gptq/qlora/rtn must also be bit-equal:
each site draws from its own generator in both), and against the JAX
package's sequential ``_quantize_one`` (where ``A`` comes from
``jax.random``, so only ``A @ B^T = 0`` is comparable for those three).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import pipeline as jp
from repro.core import recipe as jr
from repro.core.health import HealthPolicy
from repro.core.optq import gram_error as j_gram_error
from repro.models import modules as jmod
from repro.models import transformer as jt
from repro.utils import tree_paths as jpaths
from repro_torch.core import batched as tb
from repro_torch.core import pipeline as tp
from repro_torch.core import recipe as tr
from repro_torch.core.quantizer import (dequantize_int, dequantize_nf4,
                                        unpack_codes)
from repro_torch.models import modules as tmod
from repro_torch.utils import tree_paths as tpaths
from tests.torch_parity import configs, jax_to_numpy, port_params, to_np

FLIP_BUDGET = 0.005
REL = 1e-3
METHODS = ("cloq", "gptq", "loftq", "qlora", "rtn")


def _layers(n_layers, m, n, t=256, seed=0):
    rng = np.random.default_rng(seed)
    Ws = [rng.normal(size=(m, n)).astype(np.float32)
          for _ in range(n_layers)]
    Hs = []
    for _ in range(n_layers):
        X = rng.normal(size=(t, m)).astype(np.float32)
        Hs.append(X.T @ X)
    return Ws, Hs


def _tasks(Ws, Hs, seed=0):
    return [tb.LayerTask(f"l{i}", None, torch.from_numpy(W),
                         torch.from_numpy(H), tb.task_key(seed, i))
            for i, (W, H) in enumerate(zip(Ws, Hs))]


def _rel_fro(a, b) -> float:
    a = np.asarray(to_np(a), np.float64)
    b = np.asarray(to_np(b), np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _prod(lv) -> np.ndarray:
    return np.asarray(to_np(lv["lora_a"]), np.float64) @ np.asarray(
        to_np(lv["lora_b"]), np.float64).T


def _assert_leaves_close(got: dict, want: dict):
    assert set(got) == set(want)
    assert _rel_fro(_prod(got), _prod(want)) <= REL
    for k in want:
        if k in ("lora_a", "lora_b"):
            assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
            continue
        g, w = to_np(got[k]), np.asarray(to_np(want[k]))
        assert g.shape == w.shape, k
        if g.dtype == np.uint8:
            assert float(np.mean(g != w)) <= FLIP_BUDGET, k
        else:
            assert _rel_fro(g, w) <= REL, k


def _recon(lv: dict, qspec, m: int) -> np.ndarray:
    lv = {k: torch.from_numpy(np.array(to_np(v))) for k, v in lv.items()}
    if "absmax" in lv:
        Qd = dequantize_nf4(unpack_codes(lv["qcodes"], 4, m), lv["absmax"],
                            qspec.group_size)
    else:
        Qd = dequantize_int(unpack_codes(lv["qcodes"], qspec.bits, m),
                            lv["scales"], lv["zeros"], qspec.group_size)
    return to_np(Qd).astype(np.float64) + _prod(lv)


@pytest.mark.parametrize("method", METHODS)
def test_bucket_parity_with_sequential(method):
    """Batched bucket output == the per-layer ``_quantize_one`` of the port
    and of the JAX package on an 8-layer same-shape bucket, and the
    calibrated objective of the whole init agrees to 1e-3."""
    qs = dict(bits=2, group_size=16, rank=8)
    Ws, Hs = _layers(8, 32, 48)
    tasks = _tasks(Ws, Hs)
    got = tb.quantize_layer_batch(tasks, tmod.QSpec(**qs), method)
    gram = method in tb.GRAM_METHODS
    keys = jax.random.split(jax.random.PRNGKey(0), len(Ws))
    for t, W, H, k, leaves in zip(tasks, Ws, Hs, keys, got):
        mine = tp._quantize_one(t.W, t.H if gram else None,
                                tmod.QSpec(**qs), method, t.key)
        _assert_leaves_close(leaves, mine)
        if method in ("gptq", "qlora", "rtn"):
            assert torch.equal(leaves["lora_a"], mine["lora_a"])
            assert not leaves["lora_b"].any()
        ref = jax_to_numpy(jp._quantize_one(
            jnp.asarray(W), jnp.asarray(H) if gram else None,
            jmod.QSpec(**qs), method, k))
        _assert_leaves_close(leaves, ref)
        Hd = np.asarray(H, np.float64)
        ob = float(j_gram_error(Hd, W - _recon(leaves, tmod.QSpec(**qs),
                                               32)))
        oj = float(j_gram_error(Hd, W - _recon(ref, tmod.QSpec(**qs), 32)))
        if method in ("gptq", "qlora", "rtn"):
            assert ob == pytest.approx(oj, rel=1e-5)    # the same base
        else:
            assert abs(ob - oj) <= REL * max(oj, 1e-6), (ob, oj)


@pytest.mark.parametrize("stream", [True, False])
def test_mixed_shapes_bucketed_separately(stream):
    """A heterogeneous layer set splits into per-shape buckets, matches the
    oracle layer by layer, and streaming or not gives the same bits."""
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    Wa, Ha = _layers(3, 32, 48, seed=1)
    Wb, Hb = _layers(2, 16, 24, seed=2)
    tasks = _tasks(Wa + Wb, Ha + Hb)
    buckets = tb.plan_buckets(tasks, qspec, "cloq")
    assert len(buckets) == 2
    assert sorted(len(v) for v in buckets.values()) == [2, 3]
    got = tb.quantize_layer_batch(tasks, qspec, "cloq", stream=stream)
    other = tb.quantize_layer_batch(tasks, qspec, "cloq", stream=not stream)
    for t, leaves, again in zip(tasks, got, other):
        _assert_leaves_close(leaves, tp._quantize_one(t.W, t.H, qspec,
                                                      "cloq", t.key))
        for k in leaves:
            assert torch.equal(leaves[k], again[k]), k


@pytest.mark.parametrize("m,n,method,has_gram", [
    (24, 16, "cloq", True), (256, 64, "cloq", True), (96, 32, "gptq", True),
    (64, 48, "rtn", True), (48, 32, "qlora", False)])
def test_spec_resolves_block_at_plan_time(m, n, method, has_gram):
    """The sweep block, the MagR gate and the Gram routing are resolved in
    the spec, field for field as the JAX planner resolves them."""
    qs = dict(bits=2, group_size=8, rank=4)
    got = tb.make_spec(m, n, tmod.QSpec(**qs), method, has_gram)
    want = jb.make_spec(m, n, jmod.QSpec(**qs), method, has_gram)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert m % got.block_size == 0
    assert dataclasses.asdict(tb.spec_qcfg(got)) == \
        dataclasses.asdict(jb.spec_qcfg(want))


@pytest.mark.parametrize("method", METHODS)
def test_run_bucket_single_call_shapes(method):
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    Ws, Hs = _layers(4, 32, 16)
    spec = tb.make_spec(32, 16, qspec, method, has_gram=True)
    Hst = torch.from_numpy(np.stack(Hs)) if spec.has_gram else None
    keys = [tb.task_key(0, i) for i in range(4)]
    out = tb.run_bucket(torch.from_numpy(np.stack(Ws)), Hst, keys, spec)
    assert tuple(out["qcodes"].shape) == (4, 32 * 4 // 8, 16)
    meta = "absmax" if method == "qlora" else "scales"
    assert tuple(out[meta].shape) == (4, 2, 16)
    assert tuple(out["lora_a"].shape) == (4, 32, 4)
    assert tuple(out["lora_b"].shape) == (4, 16, 4)
    seq = tb.run_bucket_sequential(torch.from_numpy(np.stack(Ws)), Hst,
                                   keys, spec)
    assert set(seq) == set(out)


@pytest.mark.parametrize("method,raises", [("cloq", True), ("gptq", True),
                                           ("rtn", False), ("loftq", False),
                                           ("qlora", False)])
def test_missing_gram_raises_for_calibrated_methods(method, raises):
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    Ws, _ = _layers(1, 16, 8)
    tasks = [tb.LayerTask("l0", None, torch.from_numpy(Ws[0]), None,
                          tb.task_key(0, 0))]
    if raises:
        with pytest.raises(ValueError, match="Gram"):
            tb.quantize_layer_batch(tasks, qspec, method)
    else:
        out = tb.quantize_layer_batch(tasks, qspec, method)
        assert tuple(out[0]["qcodes"].shape) == (16 // 2, 8)


def test_unported_options_raise(tmp_path, monkeypatch):
    """Nothing is refused any more: ``compile_cache`` names the kernel
    libraries' directory (on the CPU none is loaded, the leaves are the
    uncached ones bit for bit); a cost-model path with no calibration
    behind it raises as the JAX twin's; a mesh without a model axis plans
    the bucket replicated, the meshless leaves bit for bit (the sharded
    engine: tests/test_torch_distributed.py)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_cache", None)
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    tasks = _tasks(*_layers(1, 16, 8))
    cached = tb.quantize_layer_batch(tasks, qspec, "cloq",
                                     compile_cache=str(tmp_path / "dir"))
    assert build.active_cache().directory == tmp_path / "dir"
    assert build.active_cache().summary() == "cache hits=0 misses=0"
    with pytest.raises(FileNotFoundError, match="calibrat"):
        tb.quantize_layer_batch(tasks, qspec, "cloq",
                                cost_model="no-such-calibration.json")
    got = tb.quantize_layer_batch(tasks, qspec, "cloq", mesh=object())
    want = tb.quantize_layer_batch(tasks, qspec, "cloq")
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
        assert torch.equal(cached[0][k], want[0][k]), k


def _smoke(seed=3):
    cfg_j, cfg_t = configs()
    pj = jt.init_params(jax.random.PRNGKey(seed), cfg_j)
    from repro.data import DataConfig as JDC
    from repro.data import TokenStream as JTS
    from repro_torch.data import DataConfig as TDC
    from repro_torch.data import TokenStream as TTS
    kw = dict(vocab=cfg_j.vocab, seq_len=32, global_batch=2, seed=2)
    return (cfg_j, cfg_t, pj, port_params(pj, cfg_t),
            [JTS(JDC(**kw)).next_batch()], [TTS(TDC(**kw)).next_batch()])


def _eager_flat(qp, cfg) -> dict:
    return {k: to_np(v) for k, v in
            tpaths(tp.to_eager_params(qp, cfg)).items()}


@pytest.mark.parametrize("method", METHODS)
def test_model_parity_fewer_buckets_than_sites(method):
    """The smoke model through the port's batched and sequential engines:
    every site within the oracle (random ``A`` bit-equal), all clean under
    the health guards, and the planner folds the 14 sites into 4 buckets
    (one progress line a bucket)."""
    _, cfg, _, params, _, calib = _smoke()
    recipe = tr.QuantRecipe.single(method, tmod.QSpec(bits=4, group_size=16,
                                                      rank=8))
    msgs, flats = [], {}
    for engine in ("batched", "sequential"):
        from repro_torch.core.health import HealthReport
        report = HealthReport()
        qp, qcfg, _ = tp.quantize_model(
            params, cfg, calib, recipe=recipe, engine=engine, report=report,
            progress=msgs.append if engine == "batched" else None)
        assert report.checked == 14 and not report.counts()
        flats[engine] = _eager_flat(qp, qcfg)
    assert len(msgs) == 4 and all(m.startswith("[bucket]") for m in msgs)
    b, s = flats["batched"], flats["sequential"]
    sites = sorted({p.rsplit(".", 1)[0] for p in s if p.endswith("qcodes")})
    assert len(sites) == 14
    for site in sites:
        keys = [k for k in ("qcodes", "scales", "zeros", "absmax",
                            "lora_a", "lora_b") if f"{site}.{k}" in s]
        _assert_leaves_close({k: b[f"{site}.{k}"] for k in keys},
                             {k: s[f"{site}.{k}"] for k in keys})
        if method in ("gptq", "qlora", "rtn"):
            np.testing.assert_array_equal(b[f"{site}.lora_a"],
                                          s[f"{site}.lora_a"])


@pytest.mark.parametrize("method", METHODS)
def test_batched_engine_matches_jax_batched_engine(method):
    """The port's batched engine against the JAX batched engine on the
    smoke model (the reference's guards off, the port's on): every site
    within the oracle, the unquantized leaves bit-equal."""
    cfg_j, cfg_t, pj, pt, cj, ct = _smoke()
    qs = dict(bits=4, group_size=16, rank=8)
    qj, _, _ = jp.quantize_model(
        pj, cfg_j, cj, recipe=jr.QuantRecipe.single(method,
                                                    jmod.QSpec(**qs)),
        engine="batched", policy=HealthPolicy(enabled=False))
    qt, qcfg, _ = tp.quantize_model(
        pt, cfg_t, ct, recipe=tr.QuantRecipe.single(method,
                                                    tmod.QSpec(**qs)))
    lj = jpaths(jax_to_numpy(jp.to_eager_params(qj, cfg_j)))
    lt = _eager_flat(qt, qcfg)
    assert sorted(lj) == sorted(lt)
    sites = sorted({p.rsplit(".", 1)[0] for p in lj if p.endswith("qcodes")})
    assert len(sites) == 14
    for site in sites:
        keys = [k for k in ("qcodes", "scales", "zeros", "absmax",
                            "lora_a", "lora_b") if f"{site}.{k}" in lj]
        _assert_leaves_close({k: lt[f"{site}.{k}"] for k in keys},
                             {k: lj[f"{site}.{k}"] for k in keys})
    for path in ("embed.w", "head.w", "final_norm.scale",
                 "blocks.0.ln1.scale"):
        np.testing.assert_array_equal(lt[path], lj[path])


def test_plan_manifest_is_the_references():
    """The planner's buckets and their JSON manifest equal the JAX
    planner's for the same mixed tasks (two shapes, two recipes)."""
    Ws, Hs = _layers(3, 32, 48)
    W2, H2 = _layers(2, 16, 24, seed=1)
    q4 = dict(bits=4, group_size=16, rank=4)
    q2 = dict(bits=2, group_size=16, rank=8)
    sites_t = [tr.SiteSpec("cloq", tmod.QSpec(**q4)),
               tr.SiteSpec("rtn", tmod.QSpec(**q2))]
    sites_j = [jr.SiteSpec("cloq", jmod.QSpec(**q4)),
               jr.SiteSpec("rtn", jmod.QSpec(**q2))]
    pairs = list(zip(Ws + W2, Hs + H2))
    tasks_t = [tb.LayerTask(f"l{i}", None, torch.from_numpy(W),
                            torch.from_numpy(H), tb.task_key(0, i),
                            site=sites_t[i % 2])
               for i, (W, H) in enumerate(pairs)]
    tasks_j = [jb.LayerTask(f"l{i}", None, jnp.asarray(W), jnp.asarray(H),
                            jax.random.PRNGKey(i), site=sites_j[i % 2])
               for i, (W, H) in enumerate(pairs)]
    bt, bj = tb.plan_buckets(tasks_t), jb.plan_buckets(tasks_j)
    assert len(bt) == 4 and list(bt.values()) == list(bj.values())
    assert tb.plan_manifest(tasks_t, bt) == jb.plan_manifest(tasks_j, bj)


def _bucket_tasks(kind: str, n=6, m=32, k=24):
    """One bucket of ``n`` slices: 2-D sites, or the experts of one stacked
    site (``expert`` set, keys from (seed, site, expert))."""
    Ws, Hs = _layers(n, m, k, seed=4)
    if kind == "dense":
        return _tasks(Ws, Hs)
    W = torch.from_numpy(np.stack(Ws))
    H = torch.from_numpy(np.stack(Hs))
    return [tb.LayerTask("blocks.0.moe.up", e, W[e], H[e],
                         tb.task_key(0, 3, e)) for e in range(n)]


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("kind", ["dense", "expert"])
def test_chunked_bucket_gives_the_same_bits(kind, n_chunks):
    """A bucket of 6 slices run in 1, 2 or 3 chunks (``chunk`` 6, 3, 2):
    bit-identical leaves to the whole-bucket call, one progress line a
    bucket that names the chunks, every slice health-checked."""
    from repro_torch.core.health import HealthPolicy as TPolicy
    from repro_torch.core.health import HealthReport
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    tasks = _bucket_tasks(kind)
    whole = tb.quantize_layer_batch(tasks, qspec, "cloq")
    msgs, report = [], HealthReport()
    got = tb.quantize_layer_batch(tasks, qspec, "cloq", chunk=6 // n_chunks,
                                  progress=msgs.append, policy=TPolicy(),
                                  report=report)
    _same(got, whole)
    assert len(msgs) == 1 and f"chunks={n_chunks} " in msgs[0] + " "
    assert report.checked == 6 and not report.counts()


def test_chunk_size_fits_free_memory(monkeypatch):
    """The chunk rule: all slices off CUDA; a forced ``chunk`` capped at
    the bucket; on CUDA as many slices as ``SLICE_WORK_FACTOR`` x the
    slice's f32 W and H bytes fit in the free memory less the margin, at
    least one."""
    spec = tb.make_spec(2048, 1024, tmod.QSpec(bits=4, group_size=64,
                                               rank=64), "cloq", True)
    per = tb.SLICE_WORK_FACTOR * tb.slice_bytes(spec)
    assert tb.slice_bytes(spec) == 4 * (2048 * 1024 + 2048 * 2048)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert tb.chunk_size(spec, 300, cpu) == 300
    assert tb.chunk_size(spec, 300, cpu, chunk=7) == 7
    assert tb.chunk_size(spec, 5, cuda, chunk=7) == 5
    for free, want in ((tb.CHUNK_MARGIN_BYTES + 40.5 * per, 40),
                       (tb.CHUNK_MARGIN_BYTES + 1e15, 300),
                       (tb.CHUNK_MARGIN_BYTES // 2, 1)):
        monkeypatch.setattr(tb, "free_bytes", lambda dev, f=free: int(f))
        assert tb.chunk_size(spec, 300, cuda) == want
    rtn = tb.make_spec(2048, 1024, tmod.QSpec(), "rtn", False)
    assert tb.slice_bytes(rtn) == 4 * 2048 * 1024


def test_journal_resumes_across_chunk_sizes(tmp_path):
    """A journal written with one slice a chunk, stopped after bucket 0,
    restores that bucket under chunks of 2 (its entry does not depend on
    the chunks); the result is an uninterrupted run's, bit for bit."""
    from repro_torch.checkpoint.manager import QuantJournal
    from repro_torch.core.health import QuantPreempted
    qspec = tmod.QSpec(bits=4, group_size=16, rank=4)
    tasks = _bucket_tasks("dense", n=4) + _tasks(*_layers(3, 16, 8, seed=5))
    want = tb.quantize_layer_batch(tasks, qspec, "cloq")
    jd = str(tmp_path / "journal")
    with pytest.raises(QuantPreempted):
        tb.quantize_layer_batch(tasks, qspec, "cloq", chunk=1,
                                journal=QuantJournal(jd),
                                should_stop=lambda: True)
    assert QuantJournal(jd).buckets() == [0]
    msgs = []
    got = tb.quantize_layer_batch(tasks, qspec, "cloq", chunk=2,
                                  journal=QuantJournal(jd),
                                  progress=msgs.append)
    _same(got, want)
    assert "restored=journal" in msgs[0] and "chunks=2" in msgs[1]
