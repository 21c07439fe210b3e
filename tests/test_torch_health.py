"""Port parity: the health guards, the degradation ladder and the
fault-injection harness (``repro_torch.core.{health,faults}``).

Mirrors the fault matrix of ``tests/test_fault_tolerance.py`` on the port,
and holds it to the JAX package: the same injected fault on the same
params ends, in both packages, in the same status with the same rungs
tried and accepted.  Within one engine a fault moves no other site's
leaves by a single bit; a healed site is bit-identical across the port's
engines (both heal through the single-site core).  ``HealthReport``
serializes to the reference's JSON for the same records.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro.core import health as jh
from repro.core import pipeline as jp
from repro.core import recipe as jr
from repro.data import DataConfig as JDC
from repro.data import TokenStream as JTS
from repro.models import modules as jmod
from repro.models import transformer as jt
from repro_torch.core import faults as tf
from repro_torch.core import health as th
from repro_torch.core import pipeline as tp
from repro_torch.core import recipe as tr
from repro_torch.core.batched import make_spec, quantize_single
from repro_torch.data import DataConfig as TDC
from repro_torch.data import TokenStream as TTS
from repro_torch.models import modules as tmod
from repro_torch.utils import tree_paths
from tests.torch_parity import configs, port_params, to_np

pytestmark = pytest.mark.fault

TARGET = "blocks.0.attn.q"
QS = dict(bits=4, group_size=16, rank=4)


def _setup(calib_kind="full"):
    """The smoke model (f32, per-layer params) from JAX params, calibration
    for both packages, and the CLoQ recipe of each.  ``deficient`` is one
    16-token batch, fewer samples than d_model = 64: every Gram is
    rank-deficient, the regime ``gram_jitter`` needs."""
    cfg_j, cfg_t = configs(scan_layers=False)
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    kw = dict(vocab=cfg_j.vocab, seq_len=32, global_batch=2, seed=0)
    js, ts = JTS(JDC(**kw)), TTS(TDC(**kw))
    cj = [js.next_batch() for _ in range(2)]
    ct = [ts.next_batch() for _ in range(2)]
    if calib_kind == "deficient":
        cj = [{k: v[:1, :16] for k, v in cj[0].items()}]
        ct = [{k: v[:1, :16] for k, v in ct[0].items()}]
    return (cfg_j, cfg_t, pj, port_params(pj, cfg_t), cj, ct,
            jr.QuantRecipe.single("cloq", jmod.QSpec(**QS)),
            tr.QuantRecipe.single("cloq", tmod.QSpec(**QS)))


def _assert_all_finite(flat):
    for p, v in flat.items():
        if v.is_floating_point():
            assert bool(torch.isfinite(v).all()), f"non-finite leaf {p}"


_CLEAN: dict = {}


def _clean_run(engine, calib_kind):
    key = (engine, calib_kind)
    if key not in _CLEAN:
        _, cfg, _, params, _, calib, _, recipe = _setup(calib_kind)
        qp, _, _ = tp.quantize_model(params, cfg, calib, recipe=recipe,
                                     engine=engine)
        _CLEAN[key] = tree_paths(qp)
    return _CLEAN[key]


def _rungs(rec):
    return [(s["rung"], s["accepted"]) for s in rec["ladder"]]


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("point,expected", [
    ("gram_nan", "recovered_identity_gram"),
    ("gram_non_psd", "recovered_identity_gram"),
    ("gram_jitter", "recovered_redamp"),
])
def test_gram_fault_matrix(engine, point, expected):
    """Each Gram-level injection x each engine: the run completes, every
    leaf is finite, the report names the injected site with an accepted
    ladder (the JAX package's status and rungs for the same fault), and
    every other site is bit-identical to the same engine's clean run."""
    calib_kind = "deficient" if point == "gram_jitter" else "full"
    cfg_j, cfg, pj, params, cj, calib, rj, recipe = _setup(calib_kind)
    report = th.HealthReport()
    with tf.inject(point, match=TARGET):
        qp, _, _ = tp.quantize_model(params, cfg, calib, recipe=recipe,
                                     engine=engine, report=report)
    flat = tree_paths(qp)
    _assert_all_finite(flat)
    rec = report.records[TARGET]
    assert rec["status"] == expected, rec
    assert rec["ladder"] and rec["ladder"][-1]["accepted"], rec
    assert report.counts() == {expected: 1}
    clean = _clean_run(engine, calib_kind)
    assert set(flat) == set(clean)
    for p, leaf in flat.items():
        if not p.startswith(TARGET + "."):
            assert torch.equal(leaf, clean[p]), p
    jreport = jh.HealthReport()
    with jf.inject(point, match=TARGET):
        jp.quantize_model(pj, cfg_j, cj, recipe=rj, engine=engine,
                          report=jreport)
    jrec = jreport.records[TARGET]
    assert (jrec["status"], _rungs(jrec)) == (rec["status"], _rungs(rec))
    assert jrec["diagnosis"] == rec["diagnosis"]


def test_healed_site_bit_identical_across_engines():
    """A healed site goes through the same single-site core in both
    engines, so its leaves are bit-identical across them."""
    flats, reports = {}, {}
    for engine in ("sequential", "batched"):
        _, cfg, _, params, _, calib, _, recipe = _setup()
        reports[engine] = th.HealthReport()
        with tf.inject("gram_nan", match=TARGET):
            qp, _, _ = tp.quantize_model(params, cfg, calib, recipe=recipe,
                                         engine=engine,
                                         report=reports[engine])
        flats[engine] = tree_paths(qp)
    assert reports["sequential"].counts() == reports["batched"].counts()
    healed = [p for p in flats["batched"] if p.startswith(TARGET + ".")]
    assert len(healed) == 5
    for p in healed:
        assert torch.equal(flats["batched"][p], flats["sequential"][p]), p


@pytest.mark.parametrize("point", ["calib_nan", "calib_drop"])
def test_calibration_fault_skips_batch_and_logs(point):
    """A NaN-poisoned or dropped calibration batch is skipped and logged,
    and the run completes finite off the remaining batch."""
    _, cfg, _, params, _, calib, _, recipe = _setup()
    report = th.HealthReport()
    with tf.inject(point, match="0"):
        if point == "calib_nan":
            with pytest.warns(RuntimeWarning, match="batch 0"):
                qp, _, store = tp.quantize_model(params, cfg, calib,
                                                 recipe=recipe,
                                                 report=report)
        else:
            qp, _, store = tp.quantize_model(params, cfg, calib,
                                             recipe=recipe, report=report)
    _assert_all_finite(tree_paths(qp))
    assert any("batch 0" in e for e in report.events), report.events
    assert store.counts[TARGET] == 64          # one batch of 2 x 32


def test_calibration_all_batches_bad_raises():
    _, cfg, _, params, _, calib, _, recipe = _setup()
    with tf.inject("calib_drop", match="*"):
        with pytest.raises(RuntimeError, match="zero-sample"):
            tp.quantize_model(params, cfg, calib, recipe=recipe)


def test_non_finite_weight_is_not_healed():
    """A non-finite weight is corrupt input: the ladder raises."""
    W = torch.full((16, 8), float("nan"))
    spec = make_spec(16, 8, tmod.QSpec(bits=4, group_size=16, rank=2),
                     "rtn", False)
    with pytest.raises(FloatingPointError, match="blocks.0.x"):
        th.heal_task(W, None, 0, spec, th.HealthPolicy(), th.HealthReport(),
                     "blocks.0.x")


def test_rtn_rung_and_dense_fallback():
    """A NaN Gram skips the re-damp rungs and heals by the identity Gram;
    under a policy no rung can meet, the site falls through the identity
    Gram and RTN to dense (``None``); a data-free qlora site, which
    cannot take RTN, goes straight to dense."""
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    H = torch.full((32, 32), float("nan"))
    policy = th.HealthPolicy(blowup_factor=1e-9)      # nothing calibrated
    report = th.HealthReport()
    spec = make_spec(32, 16, tmod.QSpec(**QS), "cloq", True)
    out = th.heal_task(W, H, 0, spec, th.HealthPolicy(), report, "a")
    assert report.records["a"]["status"] == "recovered_identity_gram"
    out = th.heal_task(W, H, 0, spec, policy, report, "b")
    assert out is None and report.records["b"]["status"] == "fallback_dense"
    assert _rungs(report.records["b"]) == [("identity_gram", False),
                                           ("rtn", False)]
    q = make_spec(32, 16, tmod.QSpec(**QS), "qlora", False)
    assert th.heal_task(W, None, 0, q, policy, report, "d") is None
    assert report.records["d"]["ladder"] == []


def test_check_bucket_equals_check_single():
    """The stacked check flags exactly the slices the per-slice check
    flags: a NaN factor, and a residual blown past the RTN baseline."""
    rng = np.random.default_rng(1)
    Ws = torch.from_numpy(rng.normal(size=(3, 32, 16)).astype(np.float32))
    spec = make_spec(32, 16, tmod.QSpec(**QS), "rtn", False)
    leaves = [quantize_single(Ws[i], None, i, spec) for i in range(3)]
    leaves[1]["lora_a"][0, 0] = float("nan")
    leaves[2]["lora_b"][:] = 1.0
    leaves[2]["lora_a"][:] = 1.0
    stacked = {k: torch.stack([lv[k] for lv in leaves]) for k in leaves[0]}
    ok = th.check_bucket(Ws, stacked, spec, th.HealthPolicy())
    assert ok.tolist() == [True, False, False]
    assert [th.check_single(Ws[i], leaves[i], spec, th.HealthPolicy())
            for i in range(3)] == ok.tolist()


def _records(report):
    report.checked = 7
    report.record("blocks.0.attn.q", None, "recovered_redamp",
                  ladder=({"rung": "redamp(0.05)", "accepted": True,
                           "err": 1.5, "rtn_err": 2.0},),
                  diagnosis={"w_finite": True,
                             "gram": {"finite": True,
                                      "cholesky_finite": False}},
                  detail="lambda_frac=0.05")
    report.record("blocks.1.mlp.up", 2, "fallback_dense", detail="dense")
    report.event("calibration batch 0 dropped")
    return report


def test_health_report_json_is_the_references(tmp_path):
    got, want = _records(th.HealthReport()), _records(jh.HealthReport())
    assert json.dumps(got.to_dict(), sort_keys=True) == \
        json.dumps(want.to_dict(), sort_keys=True)
    got.save(str(tmp_path / "t" / "health.json"))
    want.save(str(tmp_path / "j" / "health.json"))
    assert (tmp_path / "t" / "health.json").read_text() == \
        (tmp_path / "j" / "health.json").read_text()
    assert got.summary() == want.summary()
    assert th.HealthReport().summary() == jh.HealthReport().summary()
    assert th.HealthReport.site_key("a", 3) == jh.HealthReport.site_key(
        "a", 3)
    assert th.HealthPolicy() == th.HealthPolicy(**{
        k: getattr(jh.HealthPolicy(), k) for k in
        ("enabled", "blowup_factor", "abs_tol", "redamp_fracs")})


@pytest.mark.parametrize("point", ["gram_nan", "gram_non_psd",
                                   "gram_jitter", None])
def test_corrupt_gram_matches_reference(point):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, 24)).astype(np.float32)
    H = X.T @ X
    if point is None:
        assert tf.corrupt_gram("a", torch.from_numpy(H)) is not None
        assert tf.corrupt_gram("a", None) is None
        return
    with tf.inject(point, match="a"), jf.inject(point, match="a"):
        got = to_np(tf.corrupt_gram("a", torch.from_numpy(H)))
        want = np.asarray(jf.corrupt_gram("a", H))
        other = tf.corrupt_gram("b", torch.from_numpy(H))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(to_np(other), H)


def test_points_env_syntax_and_file_hooks(tmp_path, monkeypatch):
    assert tf.POINTS == jf.POINTS and tf.ENV_VAR == jf.ENV_VAR
    with pytest.raises(ValueError, match="unknown injection point"):
        tf.Injection("bogus")
    monkeypatch.setenv(tf.ENV_VAR, "calib_drop=3; kill_between_buckets=1")
    assert tf.active("calib_drop", 3) and not tf.active("calib_drop", 2)
    assert tf.corrupt_batch(3, {"x": 1}) is tf.DROPPED
    assert tf.active("kill_between_buckets", "1")
    monkeypatch.delenv(tf.ENV_VAR)
    assert tf.active("calib_drop", 3) is None
    with tf.inject("calib_nan", match="0"):
        b = tf.corrupt_batch(0, {"f": torch.ones(2), "t": torch.ones(
            2, dtype=torch.int32), "n": np.ones(2, np.float32)})
    assert torch.isnan(b["f"]).all() and b["t"].eq(1).all()
    assert np.isnan(b["n"]).all()
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 100)
    tf.truncate_file(str(p))
    assert p.stat().st_size == 50


def test_heal_site_lora_ladder():
    """The per-site adapter ladder of a weight-shared block: a finite Gram
    is re-damped, a NaN one replaced by the identity Gram, as in JAX."""
    rng = np.random.default_rng(3)
    dW = rng.normal(size=(24, 16)).astype(np.float32)
    X = rng.normal(size=(40, 24)).astype(np.float32)
    for H, status in ((X.T @ X, "recovered_redamp"),
                      (np.full((24, 24), np.nan, np.float32),
                       "recovered_identity_gram")):
        got, want = th.HealthReport(), jh.HealthReport()
        A, B = th.heal_site_lora(torch.from_numpy(H), torch.from_numpy(dW),
                                 4, "paper", th.HealthPolicy(), got, "p",
                                 "s")
        Aj, Bj = jh.heal_site_lora(H, dW, 4, "paper", jh.HealthPolicy(),
                                   want, "p", "s")
        assert got.records["p"]["status"] == status
        assert got.to_dict() == want.to_dict()
        np.testing.assert_allclose(to_np(A @ B.T), np.asarray(Aj @ Bj.T),
                                   rtol=1e-3, atol=1e-4)
