"""Persisted compile cache of the port: the CUDA kernel libraries.

The JAX package persists XLA executables across processes
(``repro.core.compile_cache``).  The one thing the port compiles that
outlives a process is a kernel library: each source in
``kernels/csrc/`` built by ``nvcc`` into a shared library with a plain C
interface (``kernels/build.py``).  This module is their store, with the
JAX cache's contract: an entry that fails to load is **corrupt** — one
``RuntimeWarning``, the file is deleted, the source is rebuilt — so the
cache can never make a run incorrect, only faster.

Key layout (sha1 over canonical JSON, :func:`canonical_digest`): kind
``"kernel"``, the source's name and the sha1 of its bytes, the compiler
flags, and the environment (:func:`kernel_env`): ``torch.__version__``,
``torch.version.cuda``, the version line of ``nvcc --version`` and the
card's compute capability.  Any of these changing is a **miss by
construction**: an edited source, a toolkit or torch upgrade, or another
card never loads a stale library.  An entry is ``<stem>.<key>.so`` beside
``<stem>.<key>.json``, which records the library's size and sha1 when it
was written.  A library is corrupt when its record is missing or
disagrees, when ``ctypes.CDLL`` fails on it, or when it lacks one of its
entry symbols.

Counters ``hits`` (a library loaded from the store that this process did
not build), ``misses`` (a library this process compiled), ``corrupt`` and
``unportable`` mirror into the ``obs.names.CACHE_*`` counters.  A CUDA
graph plays the part of the JAX package's unportable executable: built
in-process and never written to disk, each captured while a cache is in
use counts once as ``unportable`` (``launch.steps.CapturedStep``).

The JAX module's ``PersistedFunction`` (an executable per call
signature) has no counterpart: nothing in the port is compiled per call
signature — the quantization buckets run eagerly and the decode is a
``CapturedStep``.

>>> canonical_digest({"b": 1, "a": 2}) == canonical_digest({"a": 2, "b": 1})
True
>>> len(canonical_digest({"a": 2})) == 40
True
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Callable, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names

_OBS_COUNTERS = {
    "hits": obs_names.CACHE_HITS,
    "misses": obs_names.CACHE_MISSES,
    "corrupt": obs_names.CACHE_CORRUPT,
    "unportable": obs_names.CACHE_UNPORTABLE,
}
# what marks a stored library corrupt: an unreadable or disagreeing record
# (KeyError, ValueError), a failed dlopen (OSError), a missing entry
# symbol (AttributeError)
CORRUPT = (OSError, ValueError, KeyError, AttributeError)


def canonical_digest(obj) -> str:
    """sha1 hex digest of an object's canonical (sorted-key) JSON form —
    the cache-key and manifest-hash primitive (the same bytes, so the same
    digest, as the JAX package's)."""
    blob = json.dumps(obj, sort_keys=True, default=str,
                      separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def nvcc_version() -> str:
    """The version line of ``nvcc --version`` ("Cuda compilation tools,
    release 12.4, V12.4.131"); its first line names the driver only."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return next((ln for ln in lines if "release" in ln), lines[-1])


def kernel_env() -> dict:
    """What a kernel library depends on besides its source and flags."""
    import torch
    cap = torch.cuda.get_device_capability() if \
        torch.cuda.is_available() else None
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_version(), "capability": list(cap or ())}


def nvcc_command(src: Path, flags: Sequence[str], out: Path) -> list[str]:
    return [nvcc_path(), *flags, "-o", str(out), str(src)]


def _sha1_file(path: Path) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CompileCache:
    """Disk store of kernel libraries with hit/miss/corrupt counters.

    One instance per process; the directory may be shared by processes
    (each writes a temporary file and renames it into place).  ``env``
    defaults to :func:`kernel_env` (read at the first key);
    ``command(src, flags, out)`` gives the compile command (``nvcc``'s by
    default)."""

    def __init__(self, directory, *, env: dict | None = None,
                 command: Callable[[Path, Sequence[str], Path],
                                   list[str]] = nvcc_command):
        self.directory = Path(os.path.abspath(os.fspath(directory)))
        self._env = env
        self.command = command
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.unportable = 0
        self._built: set[Path] = set()

    @classmethod
    def coerce(cls, obj) -> "CompileCache | None":
        """Accept a CompileCache, a directory path, or ``None``."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, (str, os.PathLike)):
            return cls(obj)
        raise TypeError(
            f"cannot coerce {type(obj).__name__} to CompileCache")

    @property
    def env(self) -> dict:
        if self._env is None:
            self._env = kernel_env()
        return self._env

    def _tally(self, event: str) -> None:
        """Bump the per-instance counter and its registry mirror."""
        setattr(self, event, getattr(self, event) + 1)
        obs_metrics.counter(_OBS_COUNTERS[event]).inc()

    def count_unportable(self) -> None:
        """One CUDA graph captured while this cache is in use."""
        self._tally("unportable")

    def key(self, src: Path, flags: Sequence[str]) -> str:
        return canonical_digest({
            "kind": "kernel", "source": Path(src).name,
            "sha1": _sha1_file(Path(src)), "flags": list(flags),
            "env": self.env})

    def path(self, src: Path, flags: Sequence[str]) -> Path:
        """Where the library of ``src`` built with ``flags`` is stored."""
        return self.directory / f"{Path(src).stem}.{self.key(src, flags)}.so"

    @staticmethod
    def _record(lib: Path) -> Path:
        return lib.with_suffix(".json")

    def _write_record(self, lib: Path, built: Path) -> None:
        """Record ``built``'s size and sha1 as those of ``lib``."""
        rec = self._record(lib)
        tmp = rec.with_name(f"{rec.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps({"bytes": built.stat().st_size,
                                   "sha1": _sha1_file(built)}) + "\n")
        os.replace(tmp, rec)

    def _check_record(self, lib: Path) -> None:
        rec = json.loads(self._record(lib).read_text())
        size = lib.stat().st_size
        if size != rec["bytes"] or _sha1_file(lib) != rec["sha1"]:
            raise ValueError(f"{size} bytes that do not match the "
                             f"{rec['bytes']} recorded")

    def build(self, jobs: Sequence[tuple[Path, Sequence[str]]]
              ) -> dict[str, str]:
        """Compile every ``(source, flags)`` whose library is not stored
        yet, all at once (one compiler process each).  Returns ``{source
        name: compiler log}`` of those compiled; raises RuntimeError with
        the logs of the ones that failed."""
        procs = {}
        for src, flags in jobs:
            lib = self.path(src, flags)
            if lib.exists() or Path(src).name in procs:
                continue
            self.directory.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            procs[Path(src).name] = (lib, tmp, subprocess.Popen(
                self.command(Path(src), flags, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (lib, tmp, proc) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode or not tmp.exists():
                failed.append(name)
                tmp.unlink(missing_ok=True)
                continue
            self._write_record(lib, tmp)
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(logs[name])
            self._built.add(lib)
            self._tally("misses")
        if failed:
            raise RuntimeError("compile failed for " + ", ".join(failed)
                               + ":\n" + "\n".join(logs[s] for s in failed))
        return logs

    def _open(self, lib: Path, symbols: Sequence[str]) -> ctypes.CDLL:
        """Load ``lib`` after checking it against its record; raises one
        of :data:`CORRUPT` when it is not whole."""
        self._check_record(lib)
        handle = ctypes.CDLL(str(lib))
        missing = [s for s in symbols if not hasattr(handle, s)]
        if missing:
            # unload it, or a rebuild at the same path would reopen it
            import _ctypes
            _ctypes.dlclose(handle._handle)
            raise AttributeError(f"no entry symbol {', '.join(missing)}")
        return handle

    def load(self, src: Path, flags: Sequence[str],
             symbols: Sequence[str] = ()) -> ctypes.CDLL:
        """The loaded library of ``src``: from the store (a hit), or
        compiled first (a miss).  A stored library that is corrupt is
        warned about, deleted and rebuilt."""
        lib = self.path(src, flags)
        if lib.exists():
            try:
                handle = self._open(lib, symbols)
            except CORRUPT as e:
                self._tally("corrupt")
                warnings.warn(
                    f"corrupt kernel library {lib.name} ({type(e).__name__}:"
                    f" {e}); rebuilding", RuntimeWarning, stacklevel=2)
                for stale in (lib, self._record(lib)):
                    stale.unlink(missing_ok=True)
            else:
                if lib not in self._built:
                    self._tally("hits")
                return handle
        self.build([(src, flags)])
        return self._open(lib, symbols)

    def summary(self) -> str:
        s = f"cache hits={self.hits} misses={self.misses}"
        if self.corrupt:
            s += f" corrupt={self.corrupt}"
        if self.unportable:
            s += f" unportable={self.unportable}"
        return s
