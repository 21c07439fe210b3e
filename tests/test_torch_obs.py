"""Port parity: span tracing, structured logs and the observability session
(``repro_torch.obs``) against ``repro.obs``, on the CPU.

The same calls go to both packages' tracers and loggers, and both CLIs
run the qwen3-1.7b smoke model with ``--trace-out``/``--metrics-out``.
Held exactly: events key for key (names, phases, arguments), log lines,
the multiset of span names with each span's argument keys, and the
counters of the metrics snapshots; both files pass
``tools/check_obs.py``'s validators.  The sync fence is a no-op for CPU
tensors and while a stream is capturing.
"""
import collections
import json

import pytest
import torch

from repro import obs as jobs
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro_torch import obs as tobs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from tests import torch_parity  # noqa: F401  (test process threads)
from tools import check_obs

# the fields a span's record has besides its timing
_STABLE = ("name", "ph", "args", "s")


def _drive(trace_mod):
    """The same spans, attributes, errors and instants on a fresh tracer
    of ``trace_mod``."""
    tr = trace_mod.Tracer()
    tr.enabled = True
    with tr.span("quant.model", engine="batched", sites=14) as sp:
        sp.set(done=True, ratio=0.5, obj=None)
        with tr.span("bucket.execute", bucket=0, path="stacked", shards=1,
                     layers=4):
            pass
    tr.instant("health.fallback_rtn", site="blocks.0.attn.q")
    tr.instant("serve.admit")
    with pytest.raises(KeyError):
        with tr.span("ckpt.write", step=3):
            raise KeyError("x")
    with tr.span("plain"):
        pass
    return tr


def test_tracer_events_match_jax_key_for_key():
    tj, tt = _drive(jobs.trace), _drive(tobs.trace)
    ej, et = tj.events(), tt.events()
    assert [sorted(e) for e in et] == [sorted(e) for e in ej]
    assert [{k: e[k] for k in _STABLE if k in e} for e in et] == \
        [{k: e[k] for k in _STABLE if k in e} for e in ej]
    dj, dt = tj.to_dict(), tt.to_dict()
    assert sorted(dt) == sorted(dj) == ["displayTimeUnit", "traceEvents"]
    assert [(e["name"], e["ph"]) for e in dt["traceEvents"]] == \
        [(e["name"], e["ph"]) for e in dj["traceEvents"]]
    assert not check_obs._validate_trace(dt, "port")
    tt.enabled = False
    assert tt.span("a") is tt.span("b")        # the shared no-op span
    assert tt.span("a").sync([1]) == [1]


def test_module_tracer_enable_sync_gate_and_traced(monkeypatch, tmp_path):
    """``REPRO_TRACE_SYNC`` sets the fence as in JAX; ``traced`` records
    only when enabled; ``export`` writes the chrome trace."""
    tr = tobs.trace
    try:
        monkeypatch.setenv(tr.SYNC_ENV, "1")
        tr.enable()
        assert tr.is_enabled() and tr.get_tracer().sync_fence
        tr.get_tracer().clear()

        @tr.traced("work", kind="x")
        def work(v):
            return v + 1

        assert work(1) == 2
        with tr.span("fenced") as sp:
            t = sp.sync(torch.ones(3))   # CPU tensors need no fence
        assert torch.equal(t, torch.ones(3))
        tr.export(tmp_path / "sub" / "t.json")
        doc = json.loads((tmp_path / "sub" / "t.json").read_text())
        assert [e["name"] for e in doc["traceEvents"]
                if e["ph"] == "X"] == ["work", "fenced"]
        tr.disable()
        monkeypatch.setenv(tr.SYNC_ENV, "0")
        tr.enable()
        assert not tr.get_tracer().sync_fence
    finally:
        tr.disable()
        tr.get_tracer().clear()
    assert work(2) == 3 and tr.span("x") is tr.span("y")


def test_fence_skips_cpu_and_capture(monkeypatch):
    """``fence`` synchronizes only CUDA devices, and none while the
    current stream is capturing a CUDA graph."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    tobs.trace.fence({"a": torch.ones(2), "b": [torch.zeros(1), 3]})
    assert calls == []
    # a tree whose tensors lie on a CUDA device, as the fence sees it
    monkeypatch.setattr(tobs.trace, "_cuda_devices",
                        lambda tree, out: {torch.device("cuda", 0)})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    tobs.trace.fence(object())
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    tobs.trace.fence(object())
    assert calls == [torch.device("cuda", 0)]


@pytest.mark.parametrize("msg,fields", [
    ("", dict(i=0, path="sharded", shards=2, s=0.12345)),
    ("all good", {}),
    ("", dict(i=3, spec="cloq/4b/g16/r8", shape="16x32", layers=2,
              restored="journal", x=1e-9, big=123456789.0, flag=True))])
def test_format_event_lines_equal(msg, fields):
    assert tobs.log.format_event("bucket", msg, **fields) == \
        jobs.log.format_event("bucket", msg, **fields)


def test_log_levels_and_sink():
    got = []
    tobs.log.set_sink(got.append)
    try:
        tobs.log.set_level("warn")
        tobs.log.info("quiet", x=1)
        tobs.log.warn("loud", x=2)
        tobs.log.error("bad", "msg")
        tobs.log.set_level("debug")
        tobs.log.debug("dbg", y=0.5)
        with pytest.raises(ValueError, match="unknown log level"):
            tobs.log.set_level("chatty")
    finally:
        tobs.log.set_level("info")
        tobs.log.set_sink(None)
    assert got == ["[loud] x=2", "[bad] msg", "[dbg] y=0.5"]


def test_session_exports_on_exception(tmp_path):
    """An exception inside the session still writes the trace (the span
    it broke carries ``error``) and the snapshot, and turns tracing off."""
    t_out, m_out = tmp_path / "t.json", tmp_path / "m.json"
    tobs.metrics.reset()
    with pytest.raises(RuntimeError):
        with tobs.session(t_out, m_out):
            tobs.metrics.counter("quant.buckets").inc()
            with tobs.trace.span("bucket.execute", bucket=0):
                raise RuntimeError("boom")
    assert not tobs.trace.is_enabled()
    doc = json.loads(t_out.read_text())
    ev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert ev[-1]["name"] == "bucket.execute"
    assert ev[-1]["args"] == {"bucket": 0, "error": "RuntimeError"}
    snap = json.loads(m_out.read_text())
    assert snap["counters"]["quant.buckets"] == 1
    assert tobs.default_metrics_path("train") == \
        jobs.default_metrics_path("train")
    tobs.trace.get_tracer().clear()


def _span_keys(path) -> collections.Counter:
    doc = json.loads(open(path).read())
    return collections.Counter(
        (e["name"], e["ph"], tuple(sorted(e.get("args", {}))))
        for e in doc["traceEvents"] if e["ph"] != "M")


def _validated(trace_path, metrics_path) -> dict:
    known = check_obs._known_names(check_obs._load_registry())
    trace = json.loads(open(trace_path).read())
    snap = json.loads(open(metrics_path).read())
    assert not check_obs._validate_trace(trace, str(trace_path))
    assert not check_obs._validate_snapshot(snap, known, str(metrics_path))
    return snap


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_clis_trace_and_metrics_match_jax(cli, tmp_path, monkeypatch):
    """Both CLIs on the smoke model with ``--trace-out``/``--metrics-out``
    (serve: 2 tenants over ranks 8 and 4, the engine route): the same span
    names, each with the same argument keys, as often as the JAX CLI's;
    the same counters; both files valid."""
    monkeypatch.chdir(tmp_path)
    argv = {"train": ["--arch", "qwen3-1.7b", "--smoke", "--steps", "3"],
            "serve": ["--arch", "qwen3-1.7b", "--smoke", "--tenants", "2",
                      "--ranks", "8,4"]}[cli]
    mods = {"train": (jtrain, ttrain), "serve": (jserve, tserve)}[cli]
    snaps, keys = {}, {}
    for name, mod, obs_pkg, extra in (
            ("jax", mods[0], jobs, []),
            ("port", mods[1], tobs, ["--device", "cpu"])):
        t_out, m_out = tmp_path / f"{name}-t.json", tmp_path / f"{name}-m.json"
        obs_pkg.metrics.reset()
        obs_pkg.trace.get_tracer().clear()   # a session keeps past events
        assert mod.main(argv + extra + ["--trace-out", str(t_out),
                                        "--metrics-out", str(m_out)]) == 0
        snaps[name] = _validated(t_out, m_out)
        keys[name] = _span_keys(t_out)
    assert keys["port"] == keys["jax"]
    assert snaps["port"]["counters"] == snaps["jax"]["counters"]
    want = {"train": {"train.step": 3, "bucket.execute": 4},
            "serve": {"serve.admit": 1, "bucket.execute": 4,
                      "serve.step": 16, "serve.decode": 32}}[cli]
    got = collections.Counter()
    for (name, _, _), n in keys["port"].items():
        got[name] += n
    assert all(got[k] == n for k, n in want.items()), got


def test_train_cli_default_metrics_path(tmp_path, monkeypatch):
    """Only ``--trace-out``: the snapshot lands at the default path, as
    with the JAX CLI."""
    monkeypatch.chdir(tmp_path)
    tobs.metrics.reset()
    tobs.trace.get_tracer().clear()
    assert ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "2",
                        "--device", "cpu", "--trace-out", "t.json"]) == 0
    snap = json.loads((tmp_path / tobs.default_metrics_path("train"))
                      .read_text())
    assert snap["counters"]["train.steps"] == 2
