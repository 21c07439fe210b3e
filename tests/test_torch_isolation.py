"""The port stands alone and never falls back from the card.

* No file of ``src/repro_torch`` and none of the ``chip_*.py`` scripts
  imports ``jax``, ``jaxlib`` or ``repro`` (AST scan), and a fresh
  interpreter runs a CPU decode step with ``jax`` never loaded.
* The CUDA branch of each ``ops`` wrapper raises when the kernel library
  reports an error or cannot be built; it never returns the plain
  version.  No CUDA tensor can exist on this host, so the device test and
  the library are replaced by stubs.
* Entry points raise without CUDA unless the CPU is asked for.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import compile_cache
from repro_torch.kernels import build, ops
from tests import torch_parity  # noqa: F401  (sets torch's threads)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [REPO / "chip_smoke.py", REPO / "chip_fault_check.py",
                    REPO / "chip_gram_losses.py", REPO / "chip_lora_ab.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_file_imports_jax_or_repro():
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in _port_files() if _imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_cpu_decode_without_jax_in_a_fresh_process():
    code = """
import sys, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import (decode_step, init_decode_cache,
                                            init_params)
cfg = get_smoke_config("qwen3-1.7b")
params = init_params(cfg, seed=0, device="cpu")
cache = init_decode_cache(cfg, 2, 8, device="cpu")
logits, cache = decode_step(params, cfg, cache, torch.tensor([[1], [2]]))
assert logits.shape == (2, cfg.vocab_padded) and int(cache["idx"]) == 1
import repro_torch.launch.serve, repro_torch.convert, repro_torch.kernels.ops
import repro_torch.launch.train
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class _StubFn:
    def __init__(self, rc):
        self.rc, self.calls = rc, 0

    def __call__(self, *args):
        self.calls += 1
        return self.rc


class _StubLib:
    def __init__(self, rc):
        self.dqmm_launch = _StubFn(rc)
        self.dqmm_lora_launch = _StubFn(rc)
        self.flash_attention_launch = _StubFn(rc)
        self.gram_launch = _StubFn(rc)


@pytest.fixture
def as_if_cuda(monkeypatch):
    """CPU tensors take the CUDA branch of the wrappers."""
    monkeypatch.setattr(build, "is_cuda", lambda t: True)
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)


def _operands():
    x = torch.randn(4, 64)
    packed = torch.zeros(32, 48, dtype=torch.uint8)
    s, z = torch.ones(4, 48), torch.zeros(4, 48)
    q, k = torch.randn(2, 4, 1, 16), torch.randn(2, 2, 8, 16)
    return (x, packed, s, z), (q, k, k)


def _lora():
    return torch.randn(64, 8), torch.randn(48, 8)


ALL_KERNELS = ("dequant_matmul", "dequant_matmul_lora", "flash_attention",
               "gram")


def test_cuda_branch_raises_on_kernel_error(as_if_cuda, monkeypatch):
    lib = _StubLib(rc=700)          # cudaErrorIllegalAddress
    monkeypatch.setattr(build, "load", lambda source: lib)
    ops.reset_launch_counts()
    dq, fa = _operands()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.dequant_matmul(*dq, bits=4, group_size=16)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.flash_attention(*fa, causal=False,
                            lengths=torch.tensor([8, 3], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.dequant_matmul_lora(*dq, *_lora(), bits=4, group_size=16)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.gram(dq[0])
    assert lib.dqmm_launch.calls == lib.flash_attention_launch.calls == 1
    assert lib.dqmm_lora_launch.calls == lib.gram_launch.calls == 1
    assert ops.launch_counts() == dict.fromkeys(ALL_KERNELS, 0)
    ok = _StubLib(rc=0)
    monkeypatch.setattr(build, "load", lambda source: ok)
    ops.dequant_matmul(*dq, bits=4, group_size=16)
    ops.flash_attention(*fa)
    ops.dequant_matmul_lora(*dq, *_lora(), bits=4, group_size=16)
    ops.gram(dq[0])
    assert ops.launch_counts() == dict.fromkeys(ALL_KERNELS, 1)
    ops.reset_launch_counts()


def test_cuda_branch_raises_when_build_fails(as_if_cuda, monkeypatch,
                                             tmp_path):
    monkeypatch.setattr(build, "build_root", lambda: tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_cache", None)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(compile_cache, "nvcc_path", no_nvcc)
    dq, fa = _operands()
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.dequant_matmul(*dq, bits=4, group_size=16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.flash_attention(*fa)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.dequant_matmul_lora(*dq, *_lora(), bits=4, group_size=16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.gram(dq[0])


def test_cuda_branch_validates_operands(as_if_cuda, monkeypatch):
    monkeypatch.setattr(build, "load", lambda source: _StubLib(rc=0))
    (x, packed, s, z), (q, k, v) = _operands()
    with pytest.raises(ValueError, match="bits"):
        ops.dequant_matmul(x, packed, s, z, bits=3, group_size=16)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_matmul(x, packed, s[:2], z, bits=4, group_size=16)
    with pytest.raises(TypeError):
        ops.dequant_matmul(x.double(), packed, s, z, bits=4, group_size=16)
    with pytest.raises(ValueError, match="lengths"):
        ops.flash_attention(q, k, v, lengths=torch.tensor([1, 2]))
    k_t = torch.randn(2, 2, 16, 8).transpose(2, 3)     # last dim strided
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k_t, k_t)
    a, b = _lora()
    with pytest.raises(ValueError, match="lora_a"):
        ops.dequant_matmul_lora(x, packed, s, z, a[:32], b, bits=4,
                                group_size=16)
    with pytest.raises(ValueError, match="rank"):
        ops.dequant_matmul_lora(x, packed, s, z, torch.randn(64, 129),
                                torch.randn(48, 129), bits=4, group_size=16)
    with pytest.raises(TypeError, match="lora_b"):
        ops.dequant_matmul_lora(x, packed, s, z, a, b.bfloat16(), bits=4,
                                group_size=16)
    with pytest.raises(TypeError):
        ops.gram(x.double())


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_decode_cache, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke"])
    assert init_params(cfg, device="cpu")["embed"]["w"].device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
