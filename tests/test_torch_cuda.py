"""The CUDA kernels of ``repro_torch`` against their plain versions, on the
card.  Every test is marked ``cuda`` and skips on a host without CUDA; the
file imports neither ``jax`` nor ``repro``, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances are the JAX package's kernel tolerances: dequant-matmul and
its fused LoRA variant 2e-4 in f32 and 2e-2 in bf16
(``tests/test_kernels.py:12-14``), flash attention 1e-4 in f32 and 5e-2
in bf16 (``tests/test_kernels.py:85-98``), gram rtol 1e-4 / atol 1e-2 in
f32 and 2e-2 / 2e-1 in bf16 (``tests/test_kernels.py::test_gram``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import pack_codes, quantize_int
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-4, atol=2e-4))


def _close(a, b, **tol):
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2048, 1024, 64), (3, 256, 200, 32),
                                   (128, 384, 128, 64), (1, 6144, 2048, 64),
                                   (5, 48, 40, 16), (9, 96, 130, 48)])
def test_dequant_matmul_kernel_matches_plain(cuda, bits, dtype, shape):
    M, K, N, g = shape
    codes, s, z = quantize_int(torch.randn(K, N, device=cuda), bits, g)
    packed = pack_codes(codes, bits)
    x = torch.randn(M, K, device=cuda).to(dtype)
    y = ops.dequant_matmul(x, packed, s, z, bits=bits, group_size=g)
    torch.cuda.synchronize()
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=bits,
                                     group_size=g), **_tol(dtype))


def test_dequant_matmul_kernel_on_layer_views(cuda):
    """Per-layer views of stacked params (the serve path's layout)."""
    L, M, K, N, g = 3, 4, 256, 96, 64
    codes, s, z = quantize_int(torch.randn(K, N, device=cuda), 4, g)
    packed = torch.stack([pack_codes(codes, 4)] * L)
    s3, z3 = torch.stack([s] * L), torch.stack([z] * L)
    x = torch.randn(M, K, device=cuda)
    for i in range(L):
        y = ops.dequant_matmul(x, packed[i], s3[i], z3[i], bits=4,
                               group_size=g)
        _close(y, ref.dequant_matmul_ref(x, packed[i], s3[i], z3[i], bits=4,
                                         group_size=g), rtol=2e-4, atol=2e-4)


# (B, Hq, Hkv, Sq, Sk, d, causal, lengths)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 16, True, (64, 23)),
    (2, 4, 2, 64, 64, 16, False, (40, 1)),
    (4, 16, 8, 1, 128, 128, False, (128, 97, 5, 1)),
    (1, 2, 1, 128, 128, 32, True, None),
    (1, 4, 4, 32, 96, 16, True, (96,)),
    (2, 64, 2, 3, 40, 200, True, (40, 2)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhsd", "cache"])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, layout):
    B, Hq, Hkv, Sq, Sk, d, causal, lens = case
    q = torch.randn(B, Hq, Sq, d, device=cuda).to(dtype)
    if layout == "cache":      # (B, Sk, Hkv, d) read through a transpose
        k, v = (torch.randn(B, Sk, Hkv, d, device=cuda).to(dtype)
                .transpose(1, 2) for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, Sk, d, device=cuda).to(dtype)
                for _ in range(2))
    lengths = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=cuda))
    o = ops.flash_attention(q, k, v, causal=causal, lengths=lengths)
    torch.cuda.synchronize()
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    _close(o, ref.flash_attention_ref(q, k, v, causal=causal,
                                      lengths=lengths), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1024, 2048), (1024, 6144), (1, 64),
                                   (37, 50), (300, 130), (128, 2048)])
def test_gram_kernel_matches_plain(cuda, dtype, shape):
    x = torch.randn(*shape, device=cuda).to(dtype)
    h = ops.gram(x)
    torch.cuda.synchronize()
    tol = (dict(rtol=2e-2, atol=2e-1) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-2))
    hr = ref.gram_ref(x)
    _close(h, hr, **tol)
    assert torch.equal(h, h.T)          # the mirror of each tile
    assert torch.equal(h, ops.gram(x))  # deterministic


def _lora_case(cuda, M, K, N, g, bits, r, dtype):
    codes, s, z = quantize_int(torch.randn(K, N, device=cuda) * 0.02, bits, g)
    x = torch.randn(M, K, device=cuda).to(dtype)
    a = (torch.randn(K, r, device=cuda) / K ** 0.5).to(dtype)
    b = (torch.randn(N, r, device=cuda) * 0.1).to(dtype)
    return x, pack_codes(codes, bits), s, z, a, b


# (M, K, N, g, r): bf16 takes the TMA + wgmma route where TMA can address
# the operands and mma.sync where it cannot (N % 16, r % 8, group 48 or
# 8), f32 the CUDA-core route; rows around the 128-row tile, N not a
# multiple of the tile, ranks 0 to 128, K = 6144
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1024, 2048, 1024, 64, 64),
                                   (1024, 6144, 2048, 64, 64),
                                   (1, 256, 200, 32, 8), (4, 384, 128, 64, 64),
                                   (1000, 96, 130, 48, 8),
                                   (70, 512, 384, 128, 128),
                                   (9, 64, 40, 16, 0),
                                   (127, 2048, 2048, 64, 64),
                                   (128, 2048, 6144, 32, 128),
                                   (129, 6144, 2048, 64, 8),
                                   (4096, 2048, 1024, 64, 0),
                                   (1000, 1024, 130, 128, 64),
                                   (4, 2048, 200, 64, 64),
                                   (1024, 512, 1024, 8, 64),
                                   (256, 512, 1024, 64, 12)])
def test_dequant_matmul_lora_kernel_matches_plain(cuda, bits, dtype, shape):
    M, K, N, g, r = shape
    x, packed, s, z, a, b = _lora_case(cuda, M, K, N, g, bits, r, dtype)
    y = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=bits,
                                group_size=g)
    torch.cuda.synchronize()
    _close(y, ref.dequant_matmul_lora_ref(x, packed, s, z, a, b, bits=bits,
                                          group_size=g), **_tol(dtype))


@pytest.mark.parametrize("case", [((1024, 2048, 2048, 64, 64), "wgmma"),
                                  ((1024, 2048, 1024, 64, 64), "wgmma"),
                                  ((129, 6144, 2048, 32, 128), "wgmma"),
                                  ((1000, 256, 130, 32, 64), "mma"),
                                  ((1024, 512, 1024, 8, 64), "mma")])
def test_dequant_matmul_lora_route_and_same_bits(cuda, case):
    """bf16 takes the route ``lora_plan`` names, and two runs give the same
    bits (no atomics, a fixed summation order)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.dequant_matmul import lora_plan
    (M, K, N, g, r), route = case
    x, packed, s, z, a, b = _lora_case(cuda, M, K, N, g, 4, r,
                                       torch.bfloat16)
    assert lora_plan(M, K, N, r, g, bf16=True, aligned=True,
                     n_sm=build.sm_count(x.device)).route == route
    y = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=4, group_size=g)
    y2 = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=4, group_size=g)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    want = ref.dequant_matmul_lora_ref(x, packed, s, z, a, b, bits=4,
                                       group_size=g)
    _close(y, want, **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_lora_backward_on_card(cuda, dtype):
    """The Function's dx/dA/dB on the card against autograd through the
    plain version: f32 1e-4 (other summation order at K = 2048), bf16
    2e-2 (the plain version rounds each path's dx to bf16 first)."""
    x, packed, s, z, a, b = _lora_case(cuda, 1024, 2048, 1024, 64, 4, 64,
                                       dtype)
    g = torch.randn(1024, 1024, device=cuda).to(dtype)
    grads = []
    for fn in (ops.dequant_matmul_lora, ref.dequant_matmul_lora_ref):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        y = fn(xs, packed, s, z, as_, bs, bits=4, group_size=64)
        grads.append(torch.autograd.grad(y, (xs, as_, bs), g))
    torch.cuda.synchronize()
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    for got, want in zip(*grads):
        _close(got, want, **tol)


def test_launch_counts_follow_launches(cuda):
    ops.reset_launch_counts()
    codes, s, z = quantize_int(torch.randn(64, 32, device=cuda), 4, 16)
    x = torch.randn(2, 64, device=cuda)
    ops.dequant_matmul(x, pack_codes(codes, 4), s, z, bits=4, group_size=16)
    ops.dequant_matmul_lora(x, pack_codes(codes, 4), s, z,
                            torch.randn(64, 8, device=cuda),
                            torch.randn(32, 8, device=cuda), bits=4,
                            group_size=16)
    ops.gram(x)
    q = torch.randn(1, 2, 1, 16, device=cuda)
    ops.flash_attention(q, q, q, causal=False)
    assert ops.launch_counts() == {"dequant_matmul": 1,
                                   "dequant_matmul_lora": 1,
                                   "flash_attention": 1, "gram": 1}
