"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, all sources at once (one ``nvcc`` each, started
together), into ``build/repro_torch/<hash>/`` at the root of the checkout
(git-ignored), where ``<hash>`` covers the sources and the flags, so an
edited source is rebuilt and an unchanged one is reused.  A failed build
raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("dequant_matmul.cu", "dequant_matmul_lora.cu", "flash_attention.cu",
           "gram.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


_CONST = re.compile(r"^constexpr int (\w+) = ([\w ()+*/-]+);", re.M)


def constants(source: str) -> dict[str, int]:
    """The file-scope ``constexpr int`` constants of a source in ``csrc/``,
    so that a plan function reads the kernel's tile sizes and limits from
    the one place they are defined.  A constant may use earlier ones."""
    out: dict[str, int] = {}
    for name, expr in _CONST.findall((CSRC / source).read_text()):
        out[name] = int(eval(expr.replace("/", "//"),  # noqa: S307
                             {"__builtins__": {}}, dict(out)))
    return out


def build_root() -> Path:
    """``build/repro_torch`` at the root of the checkout holding this file."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return build_root() / _digest()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _lib_path(name: str) -> Path:
    return build_dir() / (Path(name).stem + ".so")


def build_all() -> dict[str, str]:
    """Compile every source that is not built yet, all in parallel.

    Returns ``{source: compiler log}`` for the sources compiled by this call
    (``-Xptxas -v`` register and shared-memory report included).  Raises
    RuntimeError naming the source and its log when one fails."""
    out_dir = build_dir()
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return {}
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        tmp = out_dir / f"{Path(src).stem}.{os.getpid()}.tmp.so"
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode:
            failed.append(src)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(src))
    for src, log in logs.items():
        (out_dir / f"{Path(src).stem}.log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(source)))
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
