"""Port parity: the cost model, the planner on a mesh and the manifest
layouts, against the JAX package.

Planning reads only a mesh's axis names and sizes, so both packages plan
in process against a stand-in mesh of 2 on the model axis; the JAX
package's ``manifest_shardings`` builds real ``NamedSharding``s and runs
over 2 fake devices in a subprocess (``tests/util.py``
``run_with_devices``).  Cost-model decisions are held equal to JAX's under
the closed-form layer costs (the JAX package's fallback, the port's
default: PyTorch has no counterpart of XLA's ``cost_analysis``), and a
calibration file written by either package loads in the other.
"""
import json
import math
import textwrap
import types

import numpy as np
import pytest

from repro.core import batched as jb
from repro.core import costmodel as jcm
from repro.core import pipeline as jp
from repro.core.recipe import QuantRecipe as JRecipe
from repro.launch import shardings as jsh
from repro.models.modules import QSpec as JQSpec
from repro_torch import configs as tc
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import batched as tb
from repro_torch.core import costmodel as tcm
from repro_torch.core import pipeline as tp
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import shardings as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.utils import tree_paths
from tests.torch_parity import to_np  # noqa: F401  (sets torch's threads)
from tests.util import run_with_devices

ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b")
CALS = [
    # the twin's doctest table
    dict(flops_per_s=1e9, bytes_per_s=1e9, dispatch_s=1e-3,
         psum_latency_s=5e-3, psum_bytes_per_s=1e8, shard_efficiency=2.0),
    # ranks sharing one device: sharding buys nothing but collectives
    dict(flops_per_s=5e10, bytes_per_s=2e10, dispatch_s=2e-5,
         psum_latency_s=1e-4, psum_bytes_per_s=5e9, shard_efficiency=1.0),
    # a small memory budget: big buckets go sequential
    dict(flops_per_s=4e13, bytes_per_s=2e12, dispatch_s=1e-5,
         psum_latency_s=3e-5, psum_bytes_per_s=1e11, shard_efficiency=1.9,
         memory_budget_bytes=4e8),
]
GRID = [(method, m, n, L, k)
        for method in ("cloq", "gptq", "loftq", "qlora", "rtn")
        for m, n in ((64, 64), (2048, 2048), (2048, 6144), (6144, 2048),
                     (32, 48), (32, 45))
        for L in (1, 4, 56)
        for k in (1, 2, 4)]


def _jax_analytic(spec):
    return jcm.analytic_layer_costs(spec.method, spec.m, spec.n, spec.rank,
                                    spec.has_gram)


def _models(cal: dict):
    return (tcm.CostModel(tcm.CostCalibration(**cal)),
            jcm.CostModel(jcm.CostCalibration(**cal),
                          layer_costs=_jax_analytic))


def _fake_meshes(k: int):
    """Stand-ins carrying what planning reads: JAX's ``axis_names`` and
    ``shape``, the port's ``mesh_dim_names`` and ``size``."""
    jm = types.SimpleNamespace(axis_names=("model",), shape={"model": k})
    tm = types.SimpleNamespace(mesh_dim_names=("model",),
                               size=lambda dim=0: k)
    return tm, jm


@pytest.mark.parametrize("ci", range(len(CALS)))
def test_decisions_equal_jax(ci):
    """``decide``, ``decide_geometry``, ``path_times`` and ``explain`` equal
    JAX's over a grid of methods, shapes, bucket sizes and axis sizes."""
    tmodel, jmodel = _models(CALS[ci])
    for method, m, n, L, k in GRID:
        rank = 8 if m < 100 else 64
        geo = dict(m=m, n=n, L=L, k=k, rank=rank)
        assert tmodel.decide_geometry(method, **geo) == \
            jmodel.decide_geometry(method, **geo)
        spec = tb.make_spec(m, n, TQSpec(bits=4, group_size=16, rank=rank),
                            method, True)
        jspec = jb.make_spec(m, n, JQSpec(bits=4, group_size=16, rank=rank),
                             method, True)
        assert tmodel.decide(spec, L, k) == jmodel.decide(jspec, L, k)
        tt, jt = tmodel.path_times(spec, L, k), jmodel.path_times(jspec, L, k)
        assert tt.keys() == jt.keys()
        for p in tt:
            assert tt[p] == pytest.approx(jt[p], rel=1e-12)
        assert tmodel.explain(spec, L, k) == jmodel.explain(jspec, L, k)
    assert tcm.analytic_layer_costs("cloq", 64, 48, 8, True) == \
        jcm.analytic_layer_costs("cloq", 64, 48, 8, True)


def test_doctest_cases_and_coerce(tmp_path):
    """The twin's doctest decisions; ``coerce`` takes a model, a table, a
    file path or None, and raises as JAX's does."""
    tmodel = tcm.CostModel(tcm.CostCalibration(**CALS[0]),
                           layer_costs=lambda s: (8.0 * s.m * s.m * s.n,
                                                  4.0 * s.m * s.n))
    assert tmodel.decide_geometry("loftq", m=64, n=64, L=16, k=2)[0] == \
        "replicated"
    assert tmodel.decide_geometry("cloq", m=2048, n=2048, L=16, k=2)[0] == \
        "sharded"
    cal = tcm.CostCalibration(**CALS[1])
    assert tcm.CostModel.coerce(None) is None
    assert tcm.CostModel.coerce(tmodel) is tmodel
    assert tcm.CostModel.coerce(cal).calibration is cal
    path = cal.save(str(tmp_path / "cal.json"))
    assert tcm.CostModel.coerce(path).calibration.flops_per_s == 5e10
    with pytest.raises(FileNotFoundError, match="calibrate"):
        tcm.CostModel.coerce(str(tmp_path / "missing.json"))
    with pytest.raises(TypeError):
        tcm.CostModel.coerce(3)


def test_calibration_files_load_across_packages(tmp_path, monkeypatch):
    """A table saved by either package loads in the other, field for
    field (the unbounded memory budget as null); ``REPRO_COSTCAL`` names
    the default file in both."""
    for i, cal in enumerate(CALS):
        tp_ = str(tmp_path / f"t{i}.json")
        jp_ = str(tmp_path / f"j{i}.json")
        tcm.CostCalibration(**cal, backend="cuda").save(tp_)
        jcm.CostCalibration(**cal, backend="gpu").save(jp_)
        jl, tl = jcm.CostCalibration.load(tp_), tcm.CostCalibration.load(jp_)
        for k, v in cal.items():
            assert getattr(jl, k) == v and getattr(tl, k) == v, k
        assert jl.source == tl.source == "file"
        assert math.isinf(jl.memory_budget_bytes) == \
            ("memory_budget_bytes" not in cal)
        with open(tp_) as f:
            payload = json.load(f)
        assert set(payload) - {"torch_version"} == \
            set(json.load(open(jp_)))
    monkeypatch.setenv("REPRO_COSTCAL", str(tmp_path / "t1.json"))
    assert tcm.default_calibration_path() == jcm.default_calibration_path()
    assert tcm.load_calibration().flops_per_s == 5e10
    assert tcm.load_calibration(str(tmp_path / "none.json")) is None


def test_calibrate_on_the_cpu(tmp_path):
    """``calibrate`` measures positive rates, writes the table, and the
    next call loads it instead of measuring."""
    path = str(tmp_path / "cal.json")
    cal = tcm.calibrate(path=path, device="cpu")
    assert cal.source == "measured" and cal.backend == "cpu"
    for k in ("flops_per_s", "bytes_per_s", "dispatch_s",
              "psum_latency_s", "psum_bytes_per_s"):
        assert getattr(cal, k) > 0, k
    again = tcm.calibrate(path=path, device="cpu")
    assert again.source == "file" and again.flops_per_s == cal.flops_per_s


def _tasks_pair(n_list=(48, 45, 32), L=3):
    rng = np.random.default_rng(0)
    import jax.numpy as jnp
    import torch
    tt_, jt_ = [], []
    for n in n_list:
        for i in range(L):
            W = rng.normal(size=(32, n)).astype(np.float32)
            H = np.eye(32, dtype=np.float32)
            tt_.append(tb.LayerTask(f"{n}.{i}", None, torch.from_numpy(W),
                                    torch.from_numpy(H), i))
            jt_.append(jb.LayerTask(f"{n}.{i}", None, jnp.asarray(W),
                                    jnp.asarray(H), None))
    return tt_, jt_


@pytest.mark.parametrize("ci", range(len(CALS)))
def test_planner_on_a_mesh_equals_jax(ci):
    """``plan_buckets`` on a mesh of 2, with and without a cost model
    (``apply_cost_model``), gives JAX's buckets: specs (``n_shards`` and
    ``exec_path`` included) and members, for every method."""
    tmesh, jmesh = _fake_meshes(2)
    tmodel, jmodel = _models(CALS[ci])
    ttasks, jtasks = _tasks_pair()
    for method in ("cloq", "gptq", "loftq", "qlora", "rtn"):
        q = dict(bits=2, group_size=16, rank=8)
        for tcmod, jcmod in ((None, None), (tmodel, jmodel)):
            tplan = tb.plan_buckets(ttasks, TQSpec(**q), method, mesh=tmesh,
                                    cost_model=tcmod)
            jplan = jb.plan_buckets(jtasks, JQSpec(**q), method, mesh=jmesh,
                                    cost_model=jcmod)
            assert [(vars(s), i) for s, i in tplan.items()] == \
                [(vars(s), i) for s, i in jplan.items()]
            if tcmod is None:
                assert [s.n_shards for s in tplan] == [2, 1, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_on_a_mesh_equals_jax(arch):
    """``quantization_manifest(mesh=)`` (and with a cost model) is JAX's,
    bucket by bucket, ``n_shards`` included; ``quantized_param_shapes
    (mesh=, with_manifest=True)`` carries the same manifest."""
    from repro import configs as jcfgs
    tmesh, jmesh = _fake_meshes(2)
    tcfg, jcfg = tc.get_smoke_config(arch), jcfgs.get_smoke_config(arch)
    q = dict(bits=4, group_size=16, rank=8)
    for ci in (None, 1):
        tmodel, jmodel = (None, None) if ci is None else _models(CALS[ci])
        tman = tp.quantization_manifest(
            tcfg, recipe=TRecipe.single("cloq", TQSpec(**q)), mesh=tmesh,
            cost_model=tmodel)
        jman = jp.quantization_manifest(
            jcfg, recipe=JRecipe.single("cloq", JQSpec(**q)), mesh=jmesh,
            cost_model=jmodel)
        assert json.loads(json.dumps(tman)) == json.loads(json.dumps(jman))
        # the gate shards every bucket here; this calibration (ranks
        # sharing one device) keeps every one replicated
        assert {b["spec"]["n_shards"] for b in tman["buckets"]} == \
            ({2} if ci is None else {1})
    _, man = tp.quantized_param_shapes(
        tcfg, recipe=TRecipe.single("cloq", TQSpec(**q)), mesh=tmesh,
        with_manifest=True)
    assert man == tp.quantization_manifest(
        tcfg, recipe=TRecipe.single("cloq", TQSpec(**q)), mesh=tmesh)


_JAX_SHARDINGS = """
    import json
    from repro.checkpoint.manager import manifest_shardings
    from repro.core.costmodel import (CostCalibration, CostModel,
                                      analytic_layer_costs)
    from repro.launch.mesh import make_model_mesh
    mesh = make_model_mesh()
    cm = CostModel(CostCalibration(**{cal!r}),
                   layer_costs=lambda s: analytic_layer_costs(
                       s.method, s.m, s.n, s.rank, s.has_gram))
    out = []
    for man in json.load(open({path!r})):
        for model in (None, cm):
            sh = manifest_shardings(man, mesh, cost_model=model)
            out.append({{k: list(v.spec) for k, v in sh.items()}})
    print("SPECS=" + json.dumps(out))
"""


def test_manifest_shardings_equal_jax_partition_specs(tmp_path):
    """``manifest_shardings`` of each config's manifest (planned on a mesh
    of 2, dense, MoE and hybrid with its per-site adapters), re-resolved
    for a mesh of 2 with and without a cost model: leaf by leaf the JAX
    package's PartitionSpecs."""
    from repro import configs as jcfgs
    tmesh, _ = _fake_meshes(2)
    q = dict(bits=4, group_size=16, rank=8)
    mans = [jp.quantization_manifest(
        jcfgs.get_smoke_config(a), recipe=JRecipe.single("cloq",
                                                         JQSpec(**q)),
        mesh=_fake_meshes(2)[1]) for a in ARCHS]
    path = tmp_path / "manifests.json"
    path.write_text(json.dumps(mans))
    proc = run_with_devices(textwrap.dedent(_JAX_SHARDINGS).format(
        cal=CALS[1], path=str(path)), n_devices=2)
    want = json.loads(proc.stdout.split("SPECS=")[1])
    tmodel = tcm.CostModel(tcm.CostCalibration(**CALS[1]))
    got = []
    for man in mans:
        for model in (None, tmodel):
            sh = tckpt.manifest_shardings(man, tmesh, cost_model=model)
            got.append({k: list(v.spec) for k, v in sh.items()})
    assert got == want
    assert any("site_lora" in k for k in got[-1])
    assert any(v[-1] == "model" for v in got[0].values())


def test_manifest_shardings_warns_on_a_new_layout():
    """A manifest planned on 2 shards restored onto a mesh of 1: one
    warning naming the re-laid buckets, every leaf replicated, as in the
    JAX twin."""
    tmesh2, _ = _fake_meshes(2)
    tmesh1, _ = _fake_meshes(1)
    man = tp.quantization_manifest(
        tc.get_smoke_config("qwen3-1.7b"),
        recipe=TRecipe.single("cloq", TQSpec(bits=4, group_size=16,
                                             rank=8)), mesh=tmesh2)
    with pytest.warns(RuntimeWarning) as rec:
        sh = tckpt.manifest_shardings(man, tmesh1)
    msgs = [str(w.message) for w in rec]
    assert len(msgs) == 1 and "differs from the save-time manifest" in \
        msgs[0] and "saved sharded x2 -> restored replicated x1" in msgs[0]
    assert all(all(a is None for a in v.spec) for v in sh.values())


def test_layout_rules_equal_jax():
    """``spec_for_path`` for every leaf of each config's quantized tree,
    ``quant_bucket_specs``/``quant_task_specs`` for every method, and
    ``quant_site_specs`` on a mesh of 2 (with and without a cost model):
    the JAX package's PartitionSpecs as tuples."""
    from repro import configs as jcfgs
    tmesh, jmesh = _fake_meshes(2)
    q = dict(bits=4, group_size=16, rank=8)
    for arch in ARCHS:
        cfg = tc.get_smoke_config(arch)
        shapes = tp.quantized_param_shapes(
            cfg, recipe=TRecipe.single("cloq", TQSpec(**q)))
        for path, leaf in tree_paths(shapes).items():
            assert tsh.spec_for_path(path, leaf.dim()) == \
                tuple(jsh.spec_for_path(path, leaf.dim())), path
        tsites = TRecipe.single("cloq", TQSpec(**q)).resolve(
            tp.quantizable_linear_paths(tp._abstract_eager_shapes(cfg)))
        jcfg = jcfgs.get_smoke_config(arch)
        jshapes = jp._abstract_eager_shapes(jcfg)
        jsites = JRecipe.single("cloq", JQSpec(**q)).resolve(
            jp.quantizable_linear_paths(jshapes))
        teshapes = tp._abstract_eager_shapes(cfg)
        tmodel, jmodel = _models(CALS[1])
        for tcmod, jcmod in ((None, None), (tmodel, jmodel)):
            got = tsh.quant_site_specs(tsites, teshapes, tmesh,
                                       cost_model=tcmod)
            want = jsh.quant_site_specs(jsites, jshapes, jmesh,
                                        cost_model=jcmod)
            assert {p: {k: tuple(v) for k, v in d.items()}
                    for p, d in want.items()} == got
    for method in ("cloq", "gptq", "loftq", "qlora", "rtn"):
        for lead in (0, 1):
            for ax in ("model", None):
                assert tsh.quant_task_specs(method, ax, lead) == {
                    k: tuple(v) for k, v in
                    jsh.quant_task_specs(method, ax, lead).items()}
        assert tsh.quant_bucket_specs(method) == {
            k: tuple(v) for k, v in jsh.quant_bucket_specs(method).items()}


def test_train_and_serve_clis_take_cost_cal(tmp_path, monkeypatch, capsys):
    """``--cost-cal FILE`` plans the train CLI's and the serve CLI's
    quantization with the cost model; ``--cost-cal auto`` measures the
    host once into ``REPRO_COSTCAL`` and the next run loads it;
    ``--compile-cache`` is taken beside it."""
    monkeypatch.chdir(tmp_path)
    cal = tcm.CostCalibration(**CALS[1]).save(str(tmp_path / "cal.json"))
    rc = ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq-len", "16",
                      "--calib-batches", "1", "--cost-cal", cal])
    assert rc == 0
    assert '[done] {"final_loss": ' in capsys.readouterr().out
    auto = tmp_path / "auto.json"
    monkeypatch.setenv("REPRO_COSTCAL", str(auto))
    for _ in range(2):
        assert ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                            "cpu", "--steps", "1", "--batch", "2",
                            "--seq-len", "16", "--calib-batches", "1",
                            "--cost-cal", "auto"]) == 0
        assert auto.exists()
    assert tcm.load_calibration(str(auto)).backend == "cpu"
    rc = tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                      "--requests", "4", "--max-new", "4",
                      "--cost-cal", cal])
    assert rc == 0 and "[serve] requests=4/4" in capsys.readouterr().out
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_cache", None)
    assert ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                        "--steps", "1", "--batch", "2", "--seq-len", "16",
                        "--calib-batches", "1", "--compile-cache", "x",
                        "--cost-cal", cal]) == 0
    assert build.active_cache().directory == tmp_path / "x"
