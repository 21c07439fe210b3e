"""The port's compile cache (``repro_torch.core.compile_cache``) on the CPU.

The cache stores the CUDA kernel libraries that ``kernels/build.py``
compiles with ``nvcc``.  No compiler runs here: the compile step is a stub
that copies a real shared library of this system (``_ctypes``'s extension
module), so that ``ctypes.CDLL`` loads what the cache stores.  Pinned: a
miss then a hit; a changed source, flag or environment field is a miss; a
truncated, record-less or symbol-less library is corrupt (warned,
deleted, rebuilt, counted); ``canonical_digest`` is the JAX package's;
one process, one directory.
"""
import _ctypes
import _json
import json
import shutil
from pathlib import Path

import pytest

from repro.core.compile_cache import canonical_digest as j_digest
from repro_torch.core import compile_cache as cc
from repro_torch.kernels import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from tests import torch_parity  # noqa: F401  (sets torch's threads)

LIB = Path(_ctypes.__file__)          # exports PyInit__ctypes
OTHER = Path(_json.__file__)          # a library without that symbol
SYMBOLS = ("PyInit__ctypes",)
ENV = {"torch": "2.0", "cuda": "12.4", "capability": [9, 0],
       "nvcc": "Cuda compilation tools, release 12.4, V12.4.131"}
FLAGS = ("-O3", "-shared")


def stub(src, flags, out):
    """The compile command: a copy of a real library."""
    return ["cp", str(LIB), str(out)]


@pytest.fixture
def source(tmp_path):
    src = tmp_path / "csrc" / "k.cu"
    src.parent.mkdir()
    src.write_text('extern "C" int PyInit__ctypes(void* stream) {}\n')
    return src


def _cache(directory, **kw):
    return cc.CompileCache(directory, env=dict(ENV, **kw), command=stub)


def test_miss_then_hit(source, tmp_path):
    first = _cache(tmp_path / "cache")
    lib = first.load(source, FLAGS, SYMBOLS)
    assert lib.PyInit__ctypes
    assert (first.hits, first.misses, first.corrupt) == (0, 1, 0)
    assert first.load(source, FLAGS, SYMBOLS) is not None
    assert (first.hits, first.misses) == (0, 1), "built here: not a hit"
    second = _cache(tmp_path / "cache")
    second.load(source, FLAGS, SYMBOLS)
    assert (second.hits, second.misses, second.corrupt) == (1, 0, 0)
    assert second.summary() == "cache hits=1 misses=0"
    stored = sorted(p.suffix for p in (tmp_path / "cache").iterdir())
    assert stored == [".json", ".log", ".so"]


@pytest.mark.parametrize("change", ["torch", "cuda", "nvcc", "capability",
                                    "flags", "source"])
def test_any_change_is_a_miss(change, source, tmp_path):
    """The key holds the source, its flags and the environment: changing
    any one builds a new library beside the old one."""
    _cache(tmp_path / "cache").load(source, FLAGS, SYMBOLS)
    flags = FLAGS
    env = {}
    if change == "flags":
        flags = FLAGS + ("-lineinfo",)
    elif change == "source":
        source.write_text(source.read_text() + "// edited\n")
    else:
        env = {change: "other"}
    again = _cache(tmp_path / "cache", **env)
    again.load(source, flags, SYMBOLS)
    assert (again.hits, again.misses) == (0, 1)
    assert len(list((tmp_path / "cache").glob("*.so"))) == 2


def _corrupt_case(tmp_path, source, damage):
    # built, not loaded: a library mapped into this process must not be
    # damaged in place
    _cache(tmp_path / "cache").build([(source, FLAGS)])
    cache = _cache(tmp_path / "cache")
    lib = cache.path(source, FLAGS)
    damage(lib, cache)
    before = obs_metrics.counter(obs_names.CACHE_CORRUPT).value
    with pytest.warns(RuntimeWarning, match="corrupt kernel library"):
        handle = cache.load(source, FLAGS, SYMBOLS)
    assert handle.PyInit__ctypes
    assert (cache.hits, cache.misses, cache.corrupt) == (0, 1, 1)
    assert obs_metrics.counter(obs_names.CACHE_CORRUPT).value == before + 1
    assert lib.read_bytes() == LIB.read_bytes(), "rebuilt in place"
    assert json.loads(lib.with_suffix(".json").read_text())["bytes"] == \
        LIB.stat().st_size
    return cache


def _truncate(lib, cache):
    with open(lib, "r+b") as f:
        f.truncate(lib.stat().st_size // 2)


def _drop_record(lib, cache):
    lib.with_suffix(".json").unlink()


def _symbol_less(lib, cache):
    """A whole library, recorded as such, without the entry symbol."""
    shutil.copy(OTHER, lib)
    cache._write_record(lib, lib)


@pytest.mark.parametrize("damage", [_truncate, _drop_record, _symbol_less],
                         ids=["truncated", "record-less", "symbol-less"])
def test_corrupt_library_is_warned_deleted_rebuilt(damage, source, tmp_path):
    cache = _corrupt_case(tmp_path, source, damage)
    assert cache.load(source, FLAGS, SYMBOLS) is not None
    assert cache.corrupt == 1


def test_a_failed_build_raises_with_its_log(source, tmp_path):
    cache = cc.CompileCache(tmp_path / "cache", env=ENV,
                            command=lambda s, f, o: ["sh", "-c",
                                                     "echo bad kernel; "
                                                     "exit 3"])
    with pytest.raises(RuntimeError, match="compile failed for k.cu"
                                           "(.|\n)*bad kernel"):
        cache.load(source, FLAGS, SYMBOLS)
    assert cache.misses == 0 and not list((tmp_path / "cache").glob("*.so"))


def test_counters_mirror_the_registry(source, tmp_path):
    names = (obs_names.CACHE_HITS, obs_names.CACHE_MISSES,
             obs_names.CACHE_UNPORTABLE)
    before = [obs_metrics.counter(n).value for n in names]
    _cache(tmp_path / "cache").load(source, FLAGS, SYMBOLS)
    cache = _cache(tmp_path / "cache")
    cache.load(source, FLAGS, SYMBOLS)
    cache.count_unportable()
    assert cache.summary() == "cache hits=1 misses=0 unportable=1"
    assert [obs_metrics.counter(n).value - b
            for n, b in zip(names, before)] == [1, 1, 1]


@pytest.mark.parametrize("obj", [{"b": 1, "a": [2, 3]}, [1, "x", None],
                                 {"spec": {"bits": 4, "m": 128},
                                  "t": (1, 2)}, "kernel", 3.5])
def test_canonical_digest_is_the_jax_packages(obj):
    assert cc.canonical_digest(obj) == j_digest(obj)


def test_key_is_the_canonical_digest_of_kind_source_flags_env(source,
                                                              tmp_path):
    import hashlib
    cache = _cache(tmp_path / "cache")
    assert cache.key(source, FLAGS) == cc.canonical_digest({
        "kind": "kernel", "source": "k.cu",
        "sha1": hashlib.sha1(source.read_bytes()).hexdigest(),
        "flags": list(FLAGS), "env": ENV})
    assert cache.path(source, FLAGS).name == \
        f"k.{cache.key(source, FLAGS)}.so"


def test_persisted_function_has_no_counterpart():
    """Nothing in the port is compiled per call signature."""
    assert not hasattr(cc, "PersistedFunction")
    assert "``PersistedFunction``" in cc.__doc__


def test_coerce():
    assert cc.CompileCache.coerce(None) is None
    c = cc.CompileCache("some/dir")
    assert cc.CompileCache.coerce(c) is c
    assert cc.CompileCache.coerce("d").directory == Path("d").absolute()
    with pytest.raises(TypeError):
        cc.CompileCache.coerce(3)
    assert not Path("some/dir").exists(), "nothing written before a build"


@pytest.fixture
def fresh_build(monkeypatch, source):
    """``kernels.build`` over one stub source, with no cache chosen and no
    library loaded (restored afterwards)."""
    monkeypatch.setattr(build, "CSRC", source.parent)
    monkeypatch.setattr(build, "SOURCES", (source.name,))
    monkeypatch.setattr(build, "NVCC_FLAGS", FLAGS)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_cache", None)
    return build


def test_one_process_one_directory(fresh_build, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    assert build.use_cache(b).directory == b, "nothing loaded: may change"
    build.use_cache(_cache(a))
    assert build.entry_symbols("k.cu") == SYMBOLS
    assert build.load("k.cu").PyInit__ctypes
    assert build.loaded() == ["k.cu"] and build.build_dir() == a
    assert build.use_cache(a) is build.active_cache()
    with pytest.raises(ValueError, match=f"{b}.*{a}"):
        build.use_cache(b)
    assert build.active_cache().directory == a
    assert build.use_cache().misses == 1


def test_build_all_compiles_every_missing_library_at_once(fresh_build,
                                                          tmp_path):
    build.use_cache(_cache(tmp_path / "c"))
    logs = build.build_all()
    assert list(logs) == ["k.cu"] and build.use_cache().misses == 1
    assert build.build_all() == {}
    build.load("k.cu")
    assert (build.use_cache().hits, build.use_cache().misses) == (0, 1)


def test_default_cache_is_build_root(fresh_build):
    assert build.active_cache() is None
    assert build.build_dir() == build.build_root()
    assert build.use_cache(None) is build.active_cache()


def test_compile_cache_on_the_cpu_sets_the_directory(fresh_build, tmp_path):
    """On the CPU no kernel is loaded: the argument is accepted, the
    counters stay 0, nothing is written."""
    import numpy as np
    import torch
    from repro_torch.core import batched as tb
    from repro_torch.models.modules import QSpec
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    task = tb.LayerTask(path="blocks.0.mlp.up", expert=None, W=W,
                        H=X.T @ X, key=0)
    out = tb.quantize_layer_batch([task], QSpec(bits=4, group_size=16,
                                                rank=4), "rtn",
                                  compile_cache=str(tmp_path / "cc"))
    assert out[0]["qcodes"].shape == (8, 8)
    cache = build.active_cache()
    assert cache.directory == tmp_path / "cc"
    assert (cache.hits, cache.misses, cache.corrupt, cache.unportable) == \
        (0, 0, 0, 0)
    assert not (tmp_path / "cc").exists()


def test_fault_check_plants_the_cache_fault(tmp_path):
    """chip_fault_check.py's ninth plant, its cache half: no error marking
    a library corrupt changes one line of ``core/compile_cache.py``; on a
    copy of the package with it in place a library cut to half its bytes
    is neither warned about nor rebuilt, and the load fails, which fails
    the ``compile_cache`` phase's second serve process."""
    import importlib.util
    import os
    import subprocess
    import sys
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.CACHE_SOURCE).read_text()
    fault = fc.plant_cache_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert changed == [(fc.CACHE_SOUND, fc.CACHE_FAULT)]
    with pytest.raises(ValueError):
        fc.plant_cache_fault(fault)
    copy = tmp_path / "src"
    shutil.copytree(root / "src" / "repro_torch", copy / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / fc.CACHE_SOURCE.relative_to("src")).write_text(fault)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    code = f"""
import sys, warnings
from pathlib import Path
from repro_torch.core.compile_cache import CompileCache
stub = lambda s, f, o: ["cp", {str(LIB)!r}, str(o)]
d, src = Path(sys.argv[1]), Path({str(src)!r})
CompileCache(d, env={ENV!r}, command=stub).build([(src, ())])
lib = CompileCache(d, env={ENV!r}, command=stub).path(src, ())
with open(lib, "r+b") as f:
    f.truncate(lib.stat().st_size // 2)
c = CompileCache(d, env={ENV!r}, command=stub)
warnings.simplefilter("ignore")
try:
    c.load(src, (), {SYMBOLS!r})
    print("rebuilt", c.corrupt, c.misses)
except Exception as e:
    print("failed", type(e).__name__, c.corrupt, c.misses)
"""
    got = {}
    for name, path in (("sources", root / "src"), ("fault", copy)):
        proc = subprocess.run(
            [sys.executable, "-c", code, str(tmp_path / name)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(path)))
        assert proc.returncode == 0, proc.stderr[-3000:]
        got[name] = proc.stdout.strip()
    assert got == {"sources": "rebuilt 1 1", "fault": "failed ValueError 0 0"}
    assert fc.cache_caught([{"kernel": "compile_cache", "passes": False,
                             "error": "compile_cache: serve exited 1"}])
    assert not fc.cache_caught([{"kernel": "compile_cache", "passes": True,
                                 "error": ""}])
