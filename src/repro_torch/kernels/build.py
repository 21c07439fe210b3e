"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
libraries live in a :class:`~repro_torch.core.compile_cache.CompileCache`:
by default ``build/repro_torch/`` at the root of the checkout
(git-ignored), or the directory given to :func:`use_cache` (what
``compile_cache=`` and ``--compile-cache DIR`` set).  An entry is keyed
by its source, the flags and the environment (torch, CUDA, ``nvcc``, the
card), so an edited source is rebuilt and an unchanged one is reused; a
corrupt one is warned about, deleted and rebuilt.  The build runs at first
use, every missing library at once (one ``nvcc`` each, started together).
A failed build raises with the compiler's output; nothing falls back.

One process loads its libraries from one directory: naming another once
a library is loaded raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import re
import threading
from pathlib import Path

import torch

from repro_torch.core.compile_cache import CompileCache

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("dequant_matmul.cu", "dequant_matmul_lora.cu", "flash_attention.cu",
           "gram.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_cache: CompileCache | None = None


_CONST = re.compile(r"^constexpr int (\w+) = ([\w ()+*/-]+);", re.M)
_ENTRY = re.compile(r'^extern "C" int (\w+)\(', re.M)


def constants(source: str) -> dict[str, int]:
    """The file-scope ``constexpr int`` constants of a source in ``csrc/``,
    so that a plan function reads the kernel's tile sizes and limits from
    the one place they are defined.  A constant may use earlier ones."""
    out: dict[str, int] = {}
    for name, expr in _CONST.findall((CSRC / source).read_text()):
        out[name] = int(eval(expr.replace("/", "//"),  # noqa: S307
                             {"__builtins__": {}}, dict(out)))
    return out


def entry_symbols(source: str) -> tuple[str, ...]:
    """The ``extern "C"`` entry points of a source in ``csrc/``: what its
    library must export to count as whole."""
    return tuple(_ENTRY.findall((CSRC / source).read_text()))


def build_root() -> Path:
    """``build/repro_torch`` at the root of the checkout holding this file."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def use_cache(cache=None) -> CompileCache:
    """The compile cache this process builds into and loads from.

    ``cache`` (a :class:`CompileCache` or a directory) becomes it; None
    keeps the current one, or takes the default at :func:`build_root`.
    Raises ValueError when ``cache`` names another directory than the one
    this process has already loaded libraries from."""
    global _cache
    with _lock:
        want = CompileCache.coerce(cache)
        if want is None:
            if _cache is None:
                _cache = CompileCache(build_root())
            return _cache
        if _cache is not None and _libs:
            if want.directory != _cache.directory:
                raise ValueError(
                    f"compile cache {want.directory}: this process has "
                    f"loaded kernel libraries from {_cache.directory}; one "
                    "process builds into and loads from one directory")
            return _cache
        _cache = want
        return _cache


def active_cache() -> CompileCache | None:
    """The cache in use (None until a kernel is built or a cache is set)."""
    return _cache


def loaded() -> list[str]:
    """The sources whose libraries this process has loaded."""
    return sorted(_libs)


def build_dir() -> Path:
    return use_cache().directory


def _jobs() -> list[tuple[Path, tuple[str, ...]]]:
    return [(CSRC / s, NVCC_FLAGS) for s in SOURCES]


def build_all() -> dict[str, str]:
    """Compile every source whose library is not stored yet, all in
    parallel.

    Returns ``{source: compiler log}`` for the sources compiled by this call
    (``-Xptxas -v`` register and shared-memory report included).  Raises
    RuntimeError naming the source and its log when one fails."""
    with _lock:
        return use_cache().build(_jobs())


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed (with every
    other missing one)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            cache = use_cache()
            if not cache.path(CSRC / source, NVCC_FLAGS).exists():
                cache.build(_jobs())
            lib = cache.load(CSRC / source, NVCC_FLAGS,
                             entry_symbols(source))
            _libs[source] = lib
        return lib


def is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def stream_handle(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
