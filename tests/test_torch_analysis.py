"""The port's reprolint (``repro_torch.analysis``) and its shape fleet.

* Each of the six rule ids has violating and clean fixtures read for the
  port's hazards (CUDA graph capture, ``torch.distributed``, float64,
  the global RNG, un-synced host timing); pragmas, the baseline and the
  report tier behave as the JAX package's engine, and the engine's
  ``parse_pragmas`` / ``fingerprint`` / ``apply_baseline`` /
  ``summarize`` are held against ``repro.analysis.engine`` on the same
  inputs.
* ``python -m repro_torch.analysis`` exits 0 on the tree, 1 on a seeded
  violation of each rule in a copy, 2 on a usage error; ``src/repro_torch``
  is clean with the empty baseline.
* Every (arch, recipe) cell built by the port on the meta device matches
  the JAX package's golden under ``tests/golden/shapes/``, which the port
  never writes.
"""
import dataclasses
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis import engine as jengine
from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import engine as tengine
from repro_torch.analysis import shapes
from tests import torch_parity  # noqa: F401  (sets torch's threads)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "shapes"
SRC_PATH = "src/repro_torch/core/example.py"

# (case id, rule, violating source, clean twin)
CASES = [
    ("retrace-captured-step-in-loop", "RETRACE", """
        from repro_torch.launch.steps import CapturedStep
        def serve(step, xs):
            for x in xs:
                g = CapturedStep(step)
                g(x)
        """, """
        from repro_torch.launch.steps import CapturedStep
        def serve(step, xs):
            g = CapturedStep(step)
            for x in xs:
                g(x)
        """),
    ("retrace-graph-in-loop", "RETRACE", """
        import torch
        def capture(fn, xs):
            while xs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(xs.pop())
        """, """
        import torch
        def capture(fn, xs):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(xs[0])
            for _ in xs:
                g.replay()
        """),
    ("purity-item", "PURITY", """
        def body(x):
            return x * x.sum().item()
        step = CapturedStep(body)
        """, """
        def body(x):
            return x * x.sum()
        step = CapturedStep(body)
        """),
    ("purity-print-and-branch", "PURITY", """
        def body(x, scale):
            print(x)
            if x.sum() > 0:
                x = x * scale
            return x + float(x.max())
        step = CapturedStep(body)
        """, """
        def body(x, scale):
            if x.shape[0] > 1 and scale is not None and len(x) > 1:
                x = x * scale
            return x + int(x.shape[-1])
        step = CapturedStep(body)
        """),
    ("purity-graph-body", "PURITY", """
        import torch
        def capture(g, fn, x):
            with torch.cuda.graph(g):
                y = fn(x)
                torch.cuda.synchronize()
                print(y.tolist())
        """, """
        import torch
        def capture(g, fn, x):
            with torch.cuda.graph(g):
                y = fn(x)
            torch.cuda.synchronize()
            print(y.tolist())
        """),
    ("collective-uncounted", "COLLECTIVE", """
        import torch.distributed as dist
        def sync(x, group):
            dist.all_reduce(x, group=group)
            dist.barrier()
            return x
        """, """
        from repro_torch.models import parallel
        def sync(x, group):
            return parallel.all_reduce_sum(x, group)
        """),
    ("collective-replicated-path", "COLLECTIVE", """
        from repro_torch.models import parallel
        def run(x, group, spec):
            if spec.exec_path == "replicated":
                x = parallel.all_reduce_sum(x, group)
            return x
        """, """
        from repro_torch.models import parallel
        def run(x, group, spec):
            if spec.exec_path != "replicated":
                x = parallel.all_reduce_sum(x, group)
            return x
        """),
    ("dtype-float64", "DTYPE", """
        import numpy as np
        import torch
        def f(x):
            w = np.zeros(3, dtype=np.float64)
            return x.to(torch.float64) + x.double(), w
        """, """
        import numpy as np
        import torch
        def f(x):
            w = np.zeros(3, dtype=np.float32)
            return x.to(torch.float32) + x.float(), w
        """),
    ("prng-global-rng", "PRNG", """
        import torch
        def init(w, shape):
            torch.nn.init.normal_(w)
            w.uniform_()
            return torch.randn(shape), torch.randint(0, 9, shape)
        """, """
        import torch
        def init(w, shape, gen):
            torch.nn.init.normal_(w, generator=gen)
            w.uniform_(generator=gen)
            return (torch.randn(shape, generator=gen),
                    torch.randint(0, 9, shape, generator=gen))
        """),
    ("prng-same-seed", "PRNG", """
        import torch
        def init(shape, seed):
            ga = torch.Generator().manual_seed(seed)
            gb = torch.Generator()
            gb.manual_seed(seed)
            return (torch.randn(shape, generator=ga),
                    torch.rand(shape, generator=gb))
        """, """
        import torch
        def init(shape, seed):
            ga = torch.Generator().manual_seed(seed)
            gb = torch.Generator().manual_seed(seed + 1)
            return (torch.randn(shape, generator=ga),
                    torch.rand(shape, generator=gb))
        """),
    ("bench-captured-step", "BENCH", """
        import time
        def bench(step, x):
            cap = CapturedStep(step)
            t0 = time.perf_counter()
            cap(x)
            return time.perf_counter() - t0
        """, """
        import time
        import torch
        def bench(step, x):
            cap = CapturedStep(step)
            t0 = time.perf_counter()
            cap(x)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        """),
    ("bench-ops-and-make-step", "BENCH", """
        import time
        from repro_torch.kernels import ops
        from repro_torch.launch.steps import make_train_step
        def bench(cfg, ocfg, state, batch, x):
            step = make_train_step(cfg, ocfg)
            t0 = time.time()
            state, loss = step(state, batch)
            ops.gram(x)
            return time.time() - t0
        """, """
        import time
        from repro_torch.kernels import ops
        from repro_torch.launch.steps import make_train_step
        def _sync(device):
            torch.cuda.synchronize(device)
        def bench(cfg, ocfg, state, batch, x):
            step = make_train_step(cfg, ocfg)
            t0 = time.time()
            state, loss = step(state, batch)
            h = ops.gram(x)
            _sync(x.device)
            t_step = time.time() - t0
            t0 = time.time()
            h = ops.gram(x).cpu()
            return t_step, time.time() - t0
        """),
]


def _lint(src: str, path: str = SRC_PATH):
    return analysis.lint_source(textwrap.dedent(src), path)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_fixture_pair(case):
    """The violating source gives findings of its rule only; the clean
    twin gives none."""
    _, rule, bad, clean = case
    found = _lint(bad)
    assert found and {f.rule for f in found} == {rule}, found
    assert _lint(clean) == []


def test_every_rule_has_a_fixture_pair():
    assert {c[1] for c in CASES} == set(analysis.RULE_IDS)


def test_collectives_are_allowed_in_the_wrapper_module():
    src = CASES[[c[0] for c in CASES].index("collective-uncounted")][2]
    assert _lint(src, "src/repro_torch/models/parallel.py") == []


def test_dtype_host_side_modules_exempt():
    src = "import torch\nx = torch.zeros(3, dtype=torch.float64)\n"
    assert _lint(src, "src/repro_torch/core/health.py") == []
    assert [f.rule for f in _lint(src)] == ["DTYPE"]


def test_pragmas_silence_in_place_and_file_wide():
    bad = textwrap.dedent("""
        import torch
        def f(x):
            return x.double()  # reprolint: disable=DTYPE (host-side sum)
        def g(shape):
            return torch.randn(shape)
        """)
    assert [f.rule for f in analysis.lint_source(bad, SRC_PATH)] == ["PRNG"]
    assert analysis.lint_source(
        bad + "# reprolint: disable-file=PRNG\n", SRC_PATH) == []
    assert analysis.lint_source(
        bad.replace("disable=DTYPE", "disable=all"), SRC_PATH) != []
    assert analysis.lint_source(
        "import torch\ntorch.randn(3)  # reprolint: disable=all\n",
        SRC_PATH) == []


def test_baseline_round_trip(tmp_path):
    """Saved gating findings load back as a multiset that absorbs them,
    also after the lines drift; the report tier never gates and is never
    saved."""
    src = textwrap.dedent(CASES[-2][2])
    found = analysis.lint_source(src, SRC_PATH)
    report = analysis.lint_source(src, "chip_x.py",
                                  tier=analysis.TIER_REPORT)
    assert analysis.gating(found) == found and analysis.gating(report) == []
    path = tmp_path / "baseline.json"
    analysis.save_baseline(found + report, path)
    base = analysis.load_baseline(path)
    assert sum(base.values()) == len(found)
    drifted = analysis.lint_source("\n\n\n" + src, SRC_PATH)
    marked = analysis.apply_baseline(drifted, base)
    assert all(f.baselined for f in marked)
    assert analysis.gating(marked) == []
    assert analysis.load_baseline(tmp_path / "missing.json") == {}


def _pairs(found):
    """The same findings as the port's and as the JAX package's class."""
    return found, [jengine.Finding(**dataclasses.asdict(f)) for f in found]


@pytest.mark.parametrize("fn", ["parse_pragmas", "fingerprint",
                                "apply_baseline", "summarize"])
def test_engine_matches_jax(fn):
    """On identical findings and sources the port's engine answers as
    ``repro.analysis.engine``."""
    src = textwrap.dedent("""
        x = 1  # reprolint: disable=DTYPE,prng
        y = 2  #reprolint:disable=all
        # reprolint: disable-file=BENCH
        z = 3  # reprolint: disable = RETRACE , PURITY (why)
        """)
    found = [tengine.Finding(r, "src/repro_torch/a.py", i + 1, "m",
                             context=c, code=code)
             for i, (r, c, code) in enumerate([
                 ("DTYPE", "f", "x =  1"), ("PRNG", "<module>", "y = 2"),
                 ("DTYPE", "f", "x = 1"), ("BENCH", "g", "z")])]
    t, j = _pairs(found)
    if fn == "parse_pragmas":
        assert tengine.parse_pragmas(src) == jengine.parse_pragmas(src)
    elif fn == "fingerprint":
        assert [tengine.fingerprint(f) for f in t] == \
            [jengine.fingerprint(f) for f in j]
    elif fn == "apply_baseline":
        base = tengine.load_baseline(Path("/nonexistent"))
        base.update([tengine.fingerprint(t[0]), tengine.fingerprint(t[3])])
        got = tengine.apply_baseline(t, base)
        want = jengine.apply_baseline(j, base)
        assert [dataclasses.astuple(f) for f in got] == \
            [dataclasses.astuple(f) for f in want]
    else:
        assert tengine.summarize(t) == jengine.summarize(j)
        assert tengine.summarize([]) == jengine.summarize([])
    assert tengine.RULE_IDS == jengine.RULE_IDS


def test_port_is_clean_with_the_empty_baseline():
    base_file = Path(cli.DEFAULT_BASELINE)
    assert json.loads(base_file.read_text())["findings"] == []
    found = analysis.lint_paths([REPO / "src" / "repro_torch"], root=REPO,
                                baseline=analysis.load_baseline(base_file))
    assert analysis.gating(found) == [], \
        "\n".join(f.render() for f in analysis.gating(found))


def test_cli_exits_0_on_the_tree(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert "reprolint[src/repro_torch]: clean" in out
    assert "shape-fleet: 30 (arch x recipe) cells" in out and \
        ": 0 diff(s)" in out


@pytest.fixture(scope="module")
def tree_copy(tmp_path_factory):
    """A copy of the checkout's linted files: ``src/repro_torch``, the
    ``chip_*.py`` scripts and the port's tests."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "tests").mkdir()
    for p in cli.report_files(REPO):
        dst = root / p.relative_to(REPO)
        shutil.copy(p, dst)
    return root


SEEDED = [c for c in CASES if c[0] in (
    "retrace-captured-step-in-loop", "purity-item", "collective-uncounted",
    "dtype-float64", "prng-global-rng", "bench-captured-step")]


@pytest.mark.parametrize("case", SEEDED, ids=lambda c: c[1])
def test_cli_exits_1_on_a_seeded_violation(case, tree_copy, capsys):
    """Each rule's violation seeded into a copy of ``src/repro_torch``
    gates."""
    seeded = tree_copy / "src" / "repro_torch" / "core" / "seeded.py"
    try:
        seeded.write_text(textwrap.dedent(case[2]))
        assert cli.main(["--root", str(tree_copy), "--no-shapes"]) == 1
        out = capsys.readouterr().out
        assert "src/repro_torch/core/seeded.py:" in out and \
            f": {case[1]}: " in out
    finally:
        seeded.unlink(missing_ok=True)


def test_cli_report_tier_never_gates(tree_copy, capsys):
    """Every seeded violation in a ``chip_*.py`` of the copy is reported
    and exits 0."""
    report = tree_copy / "chip_seeded.py"
    try:
        report.write_text("\n".join(textwrap.dedent(c[2]) for c in SEEDED))
        assert cli.main(["--root", str(tree_copy), "--no-shapes"]) == 0
        out = capsys.readouterr().out
        assert "reprolint[src/repro_torch]: clean" in out
        reported = out.split("reprolint[report]: ")[1]
        assert all(f"{c[1]}=" in reported for c in SEEDED)
    finally:
        report.unlink(missing_ok=True)


@pytest.mark.parametrize("argv", [["--no-such-flag"],
                                  ["--baseline"],
                                  ["--no-shapes", "--no-lint"],
                                  ["--root", "/nonexistent-checkout"]])
def test_cli_exits_2_on_a_usage_error(argv, capsys):
    try:
        rc = cli.main(argv)
    except SystemExit as e:          # argparse's own usage errors
        rc = e.code
    assert rc == 2


def test_chip_smoke_rule_cases_are_flagged_as_the_card_needs():
    """``chip_smoke.py``'s analysis phase holds PURITY and BENCH against
    the card on these functions: the rules must flag the ``.item()`` step
    and the un-synced replay, and pass their twins."""
    import chip_smoke as cs
    assert cs._rules_flag(cs.purity_item_step, "PURITY") == [7]
    assert cs._rules_flag(cs.purity_clean_step, "PURITY") == []
    assert cs._rules_flag(cs.replay_unsynced, "BENCH") == [6]
    assert cs._rules_flag(cs.replay_synced, "BENCH") == []


# -- the shape fleet ----------------------------------------------------------


@pytest.mark.parametrize("cell", shapes.fleet_cells(),
                         ids=lambda c: f"{c[0]}__{c[1]}")
def test_fleet_cell_matches_the_jax_golden(cell):
    errs = shapes.run_fleet(GOLDEN, cells=[cell])
    assert errs == [], "\n".join(errs)


def test_fleet_has_thirty_cells_and_goldens():
    cells = shapes.fleet_cells()
    assert len(cells) == 30
    assert {shapes.entry_path(GOLDEN, *c).name for c in cells} == \
        {p.name for p in GOLDEN.glob("*.json")}


def test_fleet_entry_deterministic():
    e1 = shapes.build_entry("qwen3_1p7b", "mixed_mlp2_attn4")
    e2 = shapes.build_entry("qwen3_1p7b", "mixed_mlp2_attn4")
    assert json.dumps(e1, sort_keys=True) == json.dumps(e2, sort_keys=True)
    assert e1["shapes"]["blocks.attn.q.qcodes"][1] == "uint8"


def test_fleet_drift_on_a_config_mutation(monkeypatch):
    """A doubled ``d_ff`` (interface drift) fails with field-level diffs."""
    from repro_torch import configs

    real = configs.get_smoke_config

    def mutated(name, **overrides):
        cfg = real(name, **overrides)
        return dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)

    monkeypatch.setattr(configs, "get_smoke_config", mutated)
    errs = shapes.run_fleet(GOLDEN, cells=[("qwen3_1p7b", "cloq_int4")])
    assert errs, "a doubled d_ff must drift from the golden"
    assert any(e.startswith("qwen3_1p7b__cloq_int4: shapes.") for e in errs)
    assert any("plan_bytes: golden" in e for e in errs)


def test_fleet_never_writes_the_goldens(tmp_path):
    before = {p.name: p.read_bytes() for p in GOLDEN.glob("*.json")}
    with pytest.raises(ValueError, match="tools/check_static.py"):
        shapes.run_fleet(GOLDEN, update=True)
    assert {p.name: p.read_bytes() for p in GOLDEN.glob("*.json")} == before
    errs = shapes.run_fleet(tmp_path, cells=[("qwen3_1p7b", "cloq_int4")])
    assert len(errs) == 1 and "missing golden" in errs[0]


def _fault_check():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", REPO / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    return fc


def test_fault_check_plants_the_purity_fault(tmp_path):
    """chip_fault_check.py's ninth plant, its analysis half: PURITY blind
    to ``.item()`` changes one line of ``analysis/rules_trace.py``, and on
    a copy of the package with it in place the ``.item()`` step of
    ``chip_smoke.py``'s analysis phase is no longer flagged, which fails
    that phase on PURITY (its capture raises on the card)."""
    import os
    import subprocess
    import sys
    fc = _fault_check()
    sound = (REPO / fc.PURITY_SOURCE).read_text()
    fault = fc.plant_purity_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert changed == [(fc.PURITY_SOUND, fc.PURITY_FAULT)]
    with pytest.raises(ValueError):
        fc.plant_purity_fault(fault)
    copy = tmp_path / "src"
    shutil.copytree(REPO / "src" / "repro_torch", copy / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / fc.PURITY_SOURCE.relative_to("src")).write_text(fault)
    code = ("import chip_smoke as cs; print(cs._rules_flag("
            "cs.purity_item_step, 'PURITY'), cs._rules_flag("
            "cs.replay_unsynced, 'BENCH'))")
    lines = {}
    for name, src in (("sources", REPO / "src"), ("fault", copy)):
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=str(REPO), timeout=300, env=dict(
                os.environ, PYTHONPATH=os.pathsep.join([str(src),
                                                        str(REPO)])))
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines[name] = proc.stdout.strip()
    assert lines == {"sources": "[7] [6]", "fault": "[] [6]"}
    assert fc.purity_caught([{"kernel": "analysis", "passes": False,
                              "error": "analysis: PURITY: the .item() "
                                       "capture must raise and be flagged"}])
    assert not fc.purity_caught([{"kernel": "analysis", "passes": False,
                                  "error": "analysis: fleet: 1 diff(s)"}])
    assert not fc.purity_caught([])
