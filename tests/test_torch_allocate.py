"""Port parity: calibrated bit allocation (``repro_torch.core.allocate``,
the batched engine's sensitivity sweep, ``pipeline.allocate_plan``), the
train CLI's ``--auto-allocate`` and ApiQ-lite, against the JAX package.

Tolerances and their sources:
  * byte accounting (``site_bytes``) and the solver's choices on the same
    tables: exact (integer arithmetic; the solver is the same pure Python);
  * sweep errors: 1e-3 relative, the reference's batched-vs-sequential
    oracle for the calibrated objective (``tests/test_batched.py``); the
    models' random ``A`` does not enter them (``B`` is 0 at init for gptq,
    qlora and rtn, and CLoQ's pair is closed form);
  * ApiQ-lite from JAX's initial ``A``: the f32 parity tolerance of
    ``tests/test_kernels.py:12-14`` (2e-4) on the trajectory and on ``A @
    B^T``.

The sweep runs once a module (the ``swept`` fixture) on the reference's
own small allocation model (``tests/test_allocate.py``), its params
carried across by ``convert.params_from_jax``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocate as ja
from repro.core import pipeline as jp
from repro.core.apiq_lite import apiq_lite_init as j_apiq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import SiteSpec as JSpec
from repro.data import DataConfig, TokenStream
from repro.models import transformer as jt
from repro.models.modules import QSpec as JQSpec
from repro_torch.core import allocate as ta
from repro_torch.core import batched as tb
from repro_torch.core import pipeline as tp
from repro_torch.core.apiq_lite import apiq_lite_from, apiq_lite_init
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.core.recipe import SiteSpec as TSpec
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from tests.torch_parity import TOL_F32, jax_to_numpy, port_params, to_np

GRID = (("cloq", 2, 0), ("cloq", 2, 8), ("cloq", 4, 0), ("cloq", 4, 8))
BASE = dict(bits=4, group_size=16, rank=8)
REL = 1e-3


def _small_cfgs():
    kw = dict(name="t", family="dense", n_layers=2, d_model=32, vocab=128,
              n_heads=4, n_kv_heads=2, d_ff=64)
    return (jt.ModelConfig(**kw, dtype=jnp.float32),
            tt.ModelConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def small():
    """The reference's allocation model (2 layers, width 32, f32) and one
    calibration batch, with each package's Grams."""
    cfg_j, cfg_t = _small_cfgs()
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = port_params(pj, cfg_t)
    ds = TokenStream(DataConfig(vocab=128, seq_len=32, global_batch=2,
                                seed=3))
    calib = [jax_to_numpy(ds.next_batch())]
    store_j = jp.run_calibration(jp.to_eager_params(pj, cfg_j), cfg_j, calib)
    store_t = tp.run_calibration(pt, cfg_t, calib)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt, calib=calib,
                store_j=store_j, store_t=store_t)


def _groups(pkg, small, grid=GRID):
    """Each package's swept site groups over ``grid``."""
    if pkg == "jax":
        P, A, cfg, params, store = jp, ja, small["cfg_j"], small["pj"], \
            small["store_j"]
        base, Recipe = JQSpec(**BASE), JRecipe
    else:
        P, A, cfg, params, store = tp, ta, small["cfg_t"], small["pt"], \
            small["store_t"]
        base, Recipe = TQSpec(**BASE), TRecipe
    eparams = P.to_eager_params(params, cfg)
    sites = Recipe.single("cloq", base).resolve(
        P.quantizable_linear_paths(eparams))
    tasks, _ = P._gather_tasks(eparams, store, sites, 0)
    groups = A.group_sites(P._allocation_meta(eparams, store),
                           tuple(P._STACK_KEYS))
    return A.sweep_sensitivity(tasks, groups, grid, base, cfg.dtype)


@pytest.fixture(scope="module")
def swept(small):
    return {"jax": _groups("jax", small), "torch": _groups("torch", small)}


def _uniform(cfg, Recipe, QS, bits, rank):
    return Recipe.single("cloq", QS(bits=bits, group_size=16, rank=rank))


def _budget(small):
    cfg = small["cfg_t"]
    lo = tp.recipe_plan_bytes(cfg, _uniform(cfg, TRecipe, TQSpec, 2, 0))
    hi = tp.recipe_plan_bytes(cfg, _uniform(cfg, TRecipe, TQSpec, 4, 8))
    return (lo + hi) // 2


# ---------------------------------------------------------------------------
# Byte accounting.
# ---------------------------------------------------------------------------


_DTYPES = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))


@pytest.mark.parametrize("method", ["cloq", "gptq", "loftq", "qlora", "rtn",
                                    "skip"])
def test_site_bytes_match_jax(method):
    """``site_bytes`` equals JAX's over shapes, bits, groups (the whole
    column too), ranks, dtypes, expert stacks and shared-block sites."""
    n_checked = 0
    for (m, n) in ((64, 32), (96, 160), (2048, 6144)):
        for bits in (2, 3, 4, 8):
            for g in (16, 32, None):
                for rank in (0, 8, 64):
                    for (jd, td) in _DTYPES:
                        for experts, lora_sites in ((1, 1), (4, 1), (1, 3),
                                                    (1, 0)):
                            mth = "cloq" if method == "skip" else method
                            kw = dict(bits=bits, group_size=g, rank=rank)
                            sj = JSpec(mth, JQSpec(**kw),
                                       skip=method == "skip")
                            st = TSpec(mth, TQSpec(**kw),
                                       skip=method == "skip")
                            want = ja.site_bytes(m, n, sj, jd, experts,
                                                 lora_sites)
                            got = ta.site_bytes(m, n, st, td, experts,
                                                lora_sites)
                            assert got == want, (m, n, kw, experts)
                            n_checked += 1
    assert n_checked == 3 * 4 * 3 * 3 * 2 * 4
    with pytest.raises(ValueError, match="does not divide"):
        ta.site_bytes(48, 8, TSpec("cloq", TQSpec(group_size=32)))


def test_default_grid_and_candidate_spec_match_jax():
    assert ta.default_grid() == ja.default_grid()
    assert ta.default_grid(methods=("rtn",)) == ja.default_grid(
        methods=("rtn",))
    with pytest.raises(ValueError, match="unknown method"):
        ta.default_grid(methods=("apiq",))
    for m in (64, 48, 40):
        for cand in GRID:
            sj = ja.candidate_spec(cand, JQSpec(**BASE), m)
            st = ta.candidate_spec(cand, TQSpec(**BASE), m)
            assert (sj.method, sj.skip) == (st.method, st.skip)
            assert dataclasses.asdict(sj.qspec) == \
                dataclasses.asdict(st.qspec)


# ---------------------------------------------------------------------------
# The sweep and the solver.
# ---------------------------------------------------------------------------


def test_sweep_matches_jax(swept):
    """Same groups, patterns and per-candidate bytes; proxy errors within
    1e-3 relative."""
    gj, gt = swept["jax"], swept["torch"]
    assert [g.pattern for g in gt] == [g.pattern for g in gj]
    assert len(gt) == 7 and all(g.pattern.startswith("blocks.*.")
                                for g in gt)
    for a, b in zip(gt, gj):
        assert a.paths == b.paths and (a.m, a.n) == (b.m, b.n)
        assert a.bytes_ == b.bytes_
        assert len(a.errors) == len(b.errors) == len(GRID)
        for ea, eb in zip(a.errors, b.errors):
            assert math.isfinite(ea) and abs(ea - eb) <= REL * abs(eb), \
                (a.pattern, ea, eb)
        # more bits, or a rank, never raises the error
        e = dict(zip(GRID, a.errors))
        assert e[("cloq", 4, 8)] <= e[("cloq", 4, 0)] <= e[("cloq", 2, 0)]


def _as_port(groups):
    """JAX's swept tables as the port's SiteGroups."""
    return [ta.SiteGroup(g.pattern, g.paths, g.m, g.n, g.experts,
                         g.lora_sites,
                         candidates=tuple(
                             TSpec(s.method, TQSpec(**dataclasses.asdict(
                                 s.qspec)), s.skip) for s in g.candidates),
                         bytes_=g.bytes_, errors=g.errors)
            for g in groups]


def test_solver_identical_on_jax_tables(swept):
    """On JAX's own swept tables the port's solver picks the same indices
    at every budget (hull breakpoints and between them), its budget curve
    is JAX's, and greedy equals exhaustive at the breakpoints."""
    gj = swept["jax"]
    gt = _as_port(gj)
    curve = ta.budget_curve(gt)
    assert curve == ja.budget_curve(gj)
    budgets = sorted({b for b, _ in curve} |
                     {(a + b) // 2 for (a, _), (b, _) in zip(curve,
                                                             curve[1:])})
    for b in budgets:
        assert ta.solve_budget(gt, b) == ja.solve_budget(gj, b), b
    for b, _ in ta.budget_curve(gt[:3]):
        greedy, exact = ta.solve_budget(gt[:3], b), \
            ta.solve_exhaustive(gt[:3], b)
        assert sum(g.errors[c] for g, c in zip(gt[:3], greedy)) == \
            pytest.approx(sum(g.errors[c] for g, c in zip(gt[:3], exact)),
                          rel=1e-9)
    with pytest.raises(ValueError, match="infeasible"):
        ta.solve_budget(gt, curve[0][0] - 1)
    for chain_j, g in zip(map(lambda g: ja._hull_chain(g.bytes_, g.errors),
                              gj), gt):
        assert ta._hull_chain(g.bytes_, g.errors) == chain_j


def test_solver_toy_tables_match_jax():
    """The reference's hand-built tables (a dominated candidate, equal
    costs): same choices at every budget from 0 to past the top."""
    tables = [((100, 200, 400), (30.0, 12.0, 5.0)),
              ((100, 300, 600), (50.0, 20.0, 10.0)),
              ((50, 150, 151, 500), (8.0, 4.0, 7.0, 2.0)),
              ((100, 200, 200), (9.0, 5.0, 3.0))]
    gj = [ja.SiteGroup(str(i), (str(i),), 1, 1, candidates=(None,) * len(b),
                       bytes_=b, errors=e) for i, (b, e) in enumerate(tables)]
    gt = [ta.SiteGroup(str(i), (str(i),), 1, 1, candidates=(None,) * len(b),
                       bytes_=b, errors=e) for i, (b, e) in enumerate(tables)]
    for budget in range(350, 1800, 7):
        assert ta.solve_budget(gt, budget) == ja.solve_budget(gj, budget)
    assert ta.solve_budget(gt[3:], 200) == [2]


def test_build_allocation_matches_jax(small):
    """The whole plan at the midpoint budget: the same recipe as JAX's,
    within budget, and its bytes are the plan's abstract bytes."""
    budget = _budget(small)
    aj = jp.allocate_plan(small["pj"], small["cfg_j"], small["store_j"],
                          budget, grid=GRID, qspec=JQSpec(**BASE))
    at = tp.allocate_plan(small["pt"], small["cfg_t"], small["store_t"],
                          budget, grid=GRID, qspec=TQSpec(**BASE))
    assert at.recipe.to_dict() == aj.recipe.to_dict()
    assert at.total_bytes == aj.total_bytes <= budget
    assert tp.recipe_plan_bytes(small["cfg_t"], at.recipe) == at.total_bytes
    assert abs(at.total_error - aj.total_error) <= REL * aj.total_error
    assert at.summary().splitlines()[0].startswith(
        f"allocation: {at.total_bytes}/{budget} B")
    assert len({(r["spec"].qspec.bits, r["spec"].qspec.rank)
                for r in at.table}) > 1          # the plan mixes
    # calibration batches instead of a store: the same plan
    again = tp.allocate_recipe(small["pt"], small["cfg_t"], small["calib"],
                               budget, grid=GRID, qspec=TQSpec(**BASE))
    assert again.to_dict() == at.recipe.to_dict()


def test_sweep_drops_non_finite_candidates(small, monkeypatch):
    """A candidate whose error is not finite leaves the table (reported);
    a group with none left raises."""
    eparams = small["pt"]
    tasks, _ = tp._gather_tasks(
        eparams, small["store_t"],
        TRecipe.single("cloq", TQSpec(**BASE)).resolve(
            tp.quantizable_linear_paths(eparams)), 0)
    meta = tp._allocation_meta(eparams, small["store_t"])
    lines = []
    # the engine's errors, with every 2-bit candidate's made NaN
    monkeypatch.setattr(ta, "evaluate_layer_batch", lambda ts, **kw: [
        float("nan") if t.site.qspec.bits == 2 else 1.0 + t.site.qspec.rank
        for t in ts])
    groups = ta.sweep_sensitivity(tasks, ta.group_sites(meta, ("blocks",)),
                                  GRID, TQSpec(**BASE), torch.float32,
                                  progress=lines.append)
    assert all(len(g.candidates) == 2 and
               all(s.qspec.bits == 4 for s in g.candidates) and
               g.errors == (2.0, 18.0) for g in groups)
    assert sum("dropped 2 non-finite" in ln for ln in lines) == 7
    monkeypatch.setattr(ta, "evaluate_layer_batch",
                        lambda ts, **kw: [float("inf")] * len(ts))
    with pytest.raises(RuntimeError, match="non-finite proxy error"):
        ta.sweep_sensitivity(tasks, ta.group_sites(meta, ("blocks",)),
                             GRID, TQSpec(**BASE), torch.float32)
    # the leave-dense candidate (zero error, the dense weight's bytes)
    # survives where every grid point is unusable
    groups = ta.sweep_sensitivity(tasks, ta.group_sites(meta, ("blocks",)),
                                  GRID, TQSpec(**BASE), torch.float32,
                                  include_skip=True)
    for g in groups:
        assert [s.skip for s in g.candidates] == [True]
        assert g.errors == (0.0,) and g.bytes_ == (2 * g.m * g.n * 4,)
    assert ta.solve_budget(groups, sum(g.bytes_[0] for g in groups)) == \
        [0] * len(groups)


# ---------------------------------------------------------------------------
# The engine's sweep.
# ---------------------------------------------------------------------------


def _eval_tasks(seed=0):
    rng = np.random.default_rng(seed)
    m, n, L = 32, 48, 3
    tasks = []
    for method, bits, rank in (("cloq", 2, 8), ("gptq", 4, 0),
                               ("loftq", 2, 8), ("qlora", 4, 8),
                               ("rtn", 3, 8)):
        spec = TSpec(method, TQSpec(bits=bits, group_size=16, rank=rank,
                                    method=method))
        for i in range(L):
            W = rng.normal(size=(m, n)).astype(np.float32)
            X = rng.normal(size=(256, m)).astype(np.float32)
            tasks.append(tb.LayerTask(f"{method}{i}", None,
                                      torch.from_numpy(W),
                                      torch.from_numpy(X.T @ X),
                                      tb.task_key(seed, len(tasks)),
                                      site=spec))
    return tasks


def test_evaluate_layer_batch_buckets_chunks_and_single():
    """Every task's Gram reaches its eval bucket (data-free methods'
    too); one call a bucket; one-slice chunks and the single-site core
    give the same errors; ``[sweep]`` lines in the JAX twin's format; a
    mesh without a model axis plans every bucket replicated (the sharded
    sweep: tests/test_torch_distributed.py)."""
    tasks = _eval_tasks()
    specs = list(tb.plan_buckets(tasks, for_eval=True))
    assert len(specs) == 5 and all(s.has_gram for s in specs)
    assert not any(s.has_gram for s in tb.plan_buckets(tasks)
                   if s.method in ("loftq", "qlora", "rtn"))
    lines = []
    errs = tb.evaluate_layer_batch(tasks, progress=lines.append)
    assert len(lines) == 5 and lines[0].startswith(
        "[sweep] i=0 spec=cloq/2b/g16/r8 shape=32x48 candidates=3 "
        "path=replicated shards=1")
    chunked = tb.evaluate_layer_batch(tasks, chunk=1)
    for t, e, c in zip(tasks, errs, chunked):
        spec = tb.make_spec(32, 48, t.site.qspec, t.site.method, True,
                            for_eval=True)
        one = float(tb.eval_single(t.W, t.H, t.key, spec))
        assert math.isfinite(e) and e > 0
        assert abs(c - e) <= 1e-5 * e and abs(one - e) <= 1e-5 * e, t.path
    assert tb.evaluate_layer_batch(tasks, mesh=object()) == errs


def test_evaluate_layer_batch_matches_jax():
    """The same tasks through JAX's ``evaluate_layer_batch``: errors
    within 1e-3 relative (random ``A`` meets ``B = 0``)."""
    from repro.core import batched as jb
    tasks = _eval_tasks()
    jtasks = [jb.LayerTask(t.path, None, jnp.asarray(t.W.numpy()),
                           jnp.asarray(t.H.numpy()),
                           jax.random.PRNGKey(i),
                           site=JSpec(t.site.method, JQSpec(
                               **dataclasses.asdict(t.site.qspec))))
              for i, t in enumerate(tasks)]
    want = jb.evaluate_layer_batch(jtasks)
    got = tb.evaluate_layer_batch(tasks)
    for t, a, b in zip(tasks, got, want):
        assert abs(a - b) <= REL * abs(b), (t.path, a, b)


# ---------------------------------------------------------------------------
# ApiQ-lite.
# ---------------------------------------------------------------------------


def test_apiq_lite_trajectory_matches_jax():
    """From JAX's own initial ``A`` the port's Adam loop follows JAX's
    trajectory, and lands on the same ``A @ B^T``, within f32
    tolerance; it lowers the objective toward CLoQ's closed form."""
    rng = np.random.default_rng(0)
    m, n, rank, steps = 48, 32, 4, 60
    X = rng.normal(size=(200, m)).astype(np.float32)
    H = X.T @ X
    dW = (rng.normal(size=(m, n)) * 0.1).astype(np.float32)
    Aj, Bj, trj = j_apiq(jnp.asarray(H), jnp.asarray(dW), rank, steps)
    A0 = jax.random.normal(jax.random.PRNGKey(0), (m, rank),
                           jnp.float32) / jnp.sqrt(m)
    At, Bt, trt = apiq_lite_from(torch.from_numpy(H), torch.from_numpy(dW),
                                 torch.from_numpy(np.asarray(A0)), steps)
    np.testing.assert_allclose(to_np(trt), np.asarray(trj), **TOL_F32)
    np.testing.assert_allclose(to_np(At @ Bt.T), np.asarray(Aj @ Bj.T),
                               **TOL_F32)
    assert trt[-1] < trt[0]
    A, B, tr = apiq_lite_init(torch.from_numpy(H), torch.from_numpy(dW),
                              rank, steps=3, seed=1)
    assert A.shape == (m, rank) and B.shape == (n, rank) and tr.shape == (3,)
    assert float(tr[0]) == pytest.approx(float((torch.from_numpy(dW) * (
        torch.from_numpy(H) @ torch.from_numpy(dW))).sum()), rel=1e-5)


# ---------------------------------------------------------------------------
# The train CLI.
# ---------------------------------------------------------------------------


CLI = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "2",
       "--batch", "2", "--seq-len", "16", "--calib-batches", "1"]


@pytest.mark.parametrize("flags,message", [
    (["--auto-allocate", "--budget-mb", "1", "--recipe", "r.json"],
     "conflicts with an explicit --recipe"),
    (["--auto-allocate", "--budget-mb", "1", "--method", "none"],
     "conflicts with --method none"),
    (["--budget-mb", "1"], "only applies with --auto-allocate"),
    (["--auto-allocate"], "needs --budget-mb > 0")])
def test_train_auto_allocate_misuse(flags, message):
    """The JAX CLI's four misuse messages, before anything is built."""
    with pytest.raises(SystemExit, match=message):
        ttrain.main([*CLI, *flags])


def test_train_cli_auto_allocate(tmp_path, capsys):
    """``--auto-allocate --budget-mb`` on the CPU: the plan's summary is
    printed, fits the budget, quantization follows the emitted recipe
    (the health guards clean), the fine-tune's losses are finite, and
    every checkpoint's ``meta.json`` carries the bucket manifest whose
    ``plan_fingerprint`` is the one recomputed from ``(cfg, recipe)``."""
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.recipe import plan_fingerprint
    cfg = get_smoke_config("qwen3-1.7b")
    lo = tp.recipe_plan_bytes(cfg, TRecipe.single(
        "rtn", TQSpec(bits=2, group_size=16, rank=0)))
    hi = tp.recipe_plan_bytes(cfg, TRecipe.single(
        "rtn", TQSpec(bits=4, group_size=16, rank=64)))
    budget_mb = (lo + hi) / 2 / 2**20
    args = ttrain.build_parser().parse_args(
        [*CLI, "--method", "rtn", "--group-size", "16", "--auto-allocate",
         "--budget-mb", repr(budget_mb), "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "1"])
    res = ttrain.run(args)
    out = capsys.readouterr().out
    alloc = res["allocation"]
    assert "allocation: " in out and "[allocate] s=" in out
    assert alloc.total_bytes <= int(budget_mb * 2**20)
    assert tp.recipe_plan_bytes(cfg, alloc.recipe) == alloc.total_bytes
    assert {r.method for r in alloc.recipe.rules} == {"rtn"}
    assert res["health"].checked == 14 and not res["health"].counts()
    assert all(map(math.isfinite, res["losses"])) and len(res["losses"]) == 2
    fp = plan_fingerprint(tp.quantization_manifest(res["cfg"],
                                                   recipe=alloc.recipe))
    for step in (1, 2):
        with open(tmp_path / f"step_{step:08d}" / "meta.json") as f:
            man = json.load(f)["bucket_manifest"]
        assert man["recipe"] == alloc.recipe.to_dict()
        assert plan_fingerprint(man) == fp
