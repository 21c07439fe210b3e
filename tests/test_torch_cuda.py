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
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import pack_codes, quantize_int
from repro_torch.kernels import ops, ref
# sets torch's threads; imported from the tests' own directory, which
# pytest puts on sys.path: on the card's machine another package may be
# the importable ``tests``
import torch_parity  # noqa: F401

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


# the wgmma route of gram: ragged T (1, around the 64-token stage, 1000)
# and D (8: one tile mostly past D; 136 and 2056: a 128-column tile cut at
# 8; 2048 and 6144, the calibration widths), both token splits.  Its
# products are exact in f32, so it must meet the f32 tolerance too: that
# is the check a dropped token stage or a wrong swizzle cannot pass.  One
# wgmma kernel a call: by the launches the wrapper records by route (the
# entry point launches route 1's kernel or refuses), and by the
# profiler's kernel names whenever it keeps device events (it kept none
# at all in two runs of this test on the card, even with a retry).
@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000, 1024, 4096])
@pytest.mark.parametrize("D", [8, 136, 2048, 2056, 6144])
def test_gram_wgmma_route(cuda, T, D):
    from repro_torch.kernels import gram as gm
    x = torch.randn(T, D, device=cuda).to(torch.bfloat16)
    plan = gm.plan_for(x)
    assert plan.route == "wgmma"
    calls = []

    def call():
        calls.append(1)
        ops.gram(x)

    before = dict(gm.route_launches)
    counts = _device_kernels(call, 3)
    assert gm.route_launches["wgmma"] - before["wgmma"] == len(calls)
    assert gm.route_launches["fma"] == before["fma"]
    if counts:
        kernels = {k: n for k, n in counts.items() if "gram" in k}
        assert len(kernels) == 1 and "wgmma" in next(iter(kernels)), counts
        assert next(iter(kernels.values())) == 3    # one kernel a call
    h = ops.gram(x)
    h2 = ops.gram(x)
    torch.cuda.synchronize()
    assert torch.equal(h, h.T)
    assert torch.equal(h, h2)
    hr = ref.gram_ref(x)
    _close(h, hr, rtol=2e-2, atol=2e-1)
    _close(h, hr, rtol=1e-4, atol=1e-2)


def _lora_case(cuda, M, K, N, g, bits, r, dtype, any_zero=False):
    codes, s, z = quantize_int(torch.randn(K, N, device=cuda) * 0.02, bits, g)
    if any_zero:    # shift each zero by U(-0.5, 0.5), some by -2^bits
        z = z + torch.rand_like(z) - 0.5
        z = z - (1 << bits) * (torch.rand_like(z) < 0.25)
    x = torch.randn(M, K, device=cuda).to(dtype)
    a = (torch.randn(K, r, device=cuda) / K ** 0.5).to(dtype)
    b = (torch.randn(N, r, device=cuda) * 0.1).to(dtype)
    return x, pack_codes(codes, bits), s, z, a, b


# (M, K, N, g, r): bf16 takes the TMA + wgmma route where TMA can address
# the operands and the group is a multiple of 64, mma.sync where not (N %
# 16, r % 8, group 48, 32, 16 or 8), the CUDA cores at group 4; f32 the
# CUDA-core route; rows around the 128-row tile, N not a multiple of the
# tile, ranks 0 to 128, K = 6144, a group of two stages (128)
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
                                   (256, 512, 1024, 64, 12),
                                   (64, 512, 256, 4, 16)])
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
                                  ((129, 6144, 2048, 32, 128), "mma"),
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


# the wgmma route (the training path) against its plain version: every
# bits, ranks 0 to 128, groups of one stage, two stages and all of K, rows
# of 1, 63 (one 64-row tile) and 1000 (ragged 128-row tiles), N not a
# multiple of the 128-column tile (1040, 200 + 8 = 208), and Pixtral's
# K = 14336; then zeros that are not whole numbers and some past the
# codes' range (the zero's fraction, -s (z - round(z)), non-zero on the
# tensor cores; at 8 bits past the clamp of round(z)) at every bits,
# groups 64 and 128, with a last correction block of fewer than 16 stages
# (K 2112: 33 stages; K 1088: 17; K 512: 8) and at K = 14336;
# (M, K, N, g, r, bits)
WGMMA_CASES = [(1000, 2048, 1040, 64, 64, 2), (1000, 2048, 1040, 64, 64, 4),
               (1000, 2048, 1040, 64, 64, 8), (1000, 2048, 1040, 64, 0, 4),
               (1000, 2048, 1040, 64, 8, 4), (1000, 2048, 1040, 64, 128, 4),
               (1000, 2048, 1040, 128, 64, 4), (1000, 2048, 1040, 2048, 64, 4),
               (1, 2048, 1040, 64, 64, 4), (63, 2048, 1040, 64, 64, 4),
               (1000, 6144, 208, 64, 128, 2), (63, 512, 208, 512, 0, 8),
               (1024, 2048, 1024, 64, 64, 4), (200, 14336, 512, 64, 64, 4)]
WGMMA_ANY_ZERO = [(1000, 2112, 1040, 64, 64, 2), (1000, 2112, 1040, 64, 64, 4),
                  (1000, 2112, 1040, 64, 64, 8), (63, 1088, 208, 64, 8, 8),
                  (1000, 2048, 1040, 128, 128, 8), (1, 512, 208, 64, 0, 4),
                  (1024, 2048, 1024, 64, 64, 8), (200, 14336, 512, 64, 64, 2),
                  (200, 14336, 512, 64, 64, 4), (200, 14336, 512, 64, 64, 8)]


@pytest.mark.parametrize("case", WGMMA_CASES + [
    (*c, True) for c in WGMMA_ANY_ZERO])
def test_dequant_matmul_lora_wgmma_route_matches_plain(cuda, case):
    """bf16 operands TMA can address take the wgmma route at every one of
    these shapes, agree with the plain version at the JAX bf16 tolerance,
    and give the same bits on a second run."""
    from repro_torch.kernels.dequant_matmul import lora_plan_for
    M, K, N, g, r, bits, *flag = case
    x, packed, s, z, a, b = _lora_case(cuda, M, K, N, g, bits, r,
                                       torch.bfloat16, any_zero=bool(flag))
    assert lora_plan_for(x, packed, s, z, a, b, g).route == "wgmma"
    y = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=bits,
                                group_size=g)
    y2 = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=bits,
                                 group_size=g)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    _close(y, ref.dequant_matmul_lora_ref(x, packed, s, z, a, b, bits=bits,
                                          group_size=g),
           **_tol(torch.bfloat16))


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


# the decode routes, each one launch a call: dequant_matmul's tensor-core
# route (bf16, M <= 8) and flash_attention's keys split over a cluster
# (Sq = 1; on the tensor cores in bf16, the CUDA cores in f32)
QWEN_LINEARS = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]


def _device_kernels(fn, calls, tries: int = 3):
    """Names of the device kernels ``calls`` runs of ``fn`` launch, with
    their counts (torch.profiler, keeping the events of every cycle where
    the profiler takes ``acc_events``).  On the card's machine the
    profiler has come back with no device event at all for a whole run:
    such a run is profiled again, up to ``tries`` times."""
    import inspect
    from torch.profiler import ProfilerActivity, profile
    kw = ({"acc_events": True}
          if "acc_events" in inspect.signature(profile).parameters else {})
    fn()
    torch.cuda.synchronize()
    counts: dict = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                counts[e.name] = counts.get(e.name, 0) + 1
        if counts:
            break
    return counts


def _dq_operands(cuda, M, K, N, bits, g, dtype=torch.bfloat16):
    codes, s, z = quantize_int(torch.randn(K, N, device=cuda) * 0.02, bits, g)
    x = torch.randn(M, K, device=cuda).to(dtype)
    return x, pack_codes(codes, bits), s, z


@pytest.mark.parametrize("M", [1, 3, 4, 8])
@pytest.mark.parametrize("K,N", QWEN_LINEARS)
def test_dequant_matmul_decode_route_at_qwen_linears(cuda, M, K, N):
    """bf16 at every Qwen3-1.7B linear and 1 to 8 rows: the mma route,
    within 2e-2 of the plain version, the same bits on two runs."""
    from repro_torch.kernels.dequant_matmul import plan_for
    x, packed, s, z = _dq_operands(cuda, M, K, N, 4, 64)
    assert plan_for(x, packed, s, z, 64).route == "mma"
    y = ops.dequant_matmul(x, packed, s, z, bits=4, group_size=64)
    y2 = ops.dequant_matmul(x, packed, s, z, bits=4, group_size=64)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=4, group_size=64),
           **_tol(torch.bfloat16))


# (M, K, N, g): K not a multiple of the 128-row stage, groups 32 and 128
# (and 256, which spans stages), N one tile or several
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(4, 2112, 256, 64), (3, 192, 384, 32),
                                   (8, 2048, 1024, 32), (4, 2048, 1024, 128),
                                   (1, 6144, 128, 128), (5, 1024, 512, 256),
                                   (2, 96, 16, 32)])
def test_dequant_matmul_decode_route_odd_shapes(cuda, bits, shape):
    from repro_torch.kernels.dequant_matmul import plan_for
    M, K, N, g = shape
    x, packed, s, z = _dq_operands(cuda, M, K, N, bits, g)
    assert plan_for(x, packed, s, z, g).route == "mma"
    y = ops.dequant_matmul(x, packed, s, z, bits=bits, group_size=g)
    torch.cuda.synchronize()
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=bits,
                                     group_size=g), **_tol(torch.bfloat16))


# zeros a quantizer other than the port's may write: not whole numbers,
# negative, past the codes' range; both routes take any f32 zero
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,dtype,route", [(4, torch.bfloat16, "mma"),
                                           (9, torch.bfloat16, "fma"),
                                           (4, torch.float32, "fma")])
def test_dequant_matmul_takes_any_zero(cuda, bits, M, dtype, route):
    from repro_torch.kernels.dequant_matmul import plan_for
    K, N, g = 2048, 1024, 64
    x, packed, s, z = _dq_operands(cuda, M, K, N, bits, g, dtype)
    z = z + torch.rand_like(z) - 0.5
    z = z - (1 << bits) * (torch.rand_like(z) < 0.25) \
        + 300.0 * (torch.rand_like(z) < 0.05)
    assert plan_for(x, packed, s, z, g).route == route
    y = ops.dequant_matmul(x, packed, s, z, bits=bits, group_size=g)
    torch.cuda.synchronize()
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=bits,
                                     group_size=g), **_tol(dtype))


def test_dequant_matmul_decode_route_is_one_launch(cuda):
    """One device kernel a call on the mma route, and no partial-sum
    reduction; the launch counter follows the calls."""
    x, packed, s, z = _dq_operands(cuda, 4, 6144, 2048, 4, 64)
    calls = []

    def call():
        calls.append(1)
        ops.dequant_matmul(x, packed, s, z, bits=4, group_size=64)

    ops.reset_launch_counts()
    counts = _device_kernels(call, 5)
    assert ops.launch_counts()["dequant_matmul"] == len(calls)
    kernels = {k: v for k, v in counts.items() if "dqmm" in k}
    assert len(kernels) == 1 and "mma" in next(iter(kernels)), counts
    assert next(iter(kernels.values())) == 5
    assert not any("reduce" in k for k in counts), counts


def _cache_kv(cuda, B, Sk, Hkv, d, dtype):
    return (torch.randn(B, Sk, Hkv, d, device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))


def _decode_q(cuda, B, Hq, d, dtype):
    """One query row a head.  bf16 q is scaled by 4: N(0, 16) logits put
    each row's weight on a few keys, so the outputs are O(1) against the
    5e-2 limit (at N(0, 1) logits a 4096-key output is about 0.026, and a
    lost split would pass).  f32 stays flat: 1e-4 sees every key."""
    q = torch.randn(B, Hq, 1, d, device=cuda)
    return (q * 4.0 if dtype == torch.bfloat16 else q).to(dtype)


# Sk and lengths: 1 and Sk itself, and lengths on the split boundaries
# (flash_plan's chunk: 32 keys at Sk <= 128 on 132 SMs, 1024 at 4096)
@pytest.mark.parametrize("Sk,lens", [(1, (1, 1, 1, 1)),
                                     (127, (127, 1, 64, 96)),
                                     (128, (128, 32, 64, 1)),
                                     (128, (33, 31, 96, 97)),
                                     (4096, (4096, 3072, 1024, 1)),
                                     (4096, (2048, 1025, 1023, 4095))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_split_route(cuda, Sk, lens, dtype):
    """Sq = 1 through the KV cache's transpose: keys split over a cluster,
    on the tensor cores in bf16 and on the CUDA cores in f32, within the
    reference tolerance, the same bits on two runs."""
    from repro_torch.kernels.flash_attention import plan_for
    B, Hq, Hkv, d = 4, 16, 8, 128
    q = _decode_q(cuda, B, Hq, d, dtype)
    k, v = _cache_kv(cuda, B, Sk, Hkv, d, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    plan = plan_for(q, k, v)
    assert plan.route == ("bulk" if dtype == torch.bfloat16 else "split")
    assert plan.splits * plan.chunk >= Sk
    o = ops.flash_attention(q, k, v, causal=False, lengths=lengths)
    o2 = ops.flash_attention(q, k, v, causal=False, lengths=lengths)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    _close(o, ref.flash_attention_ref(q, k, v, causal=False,
                                      lengths=lengths), **tol)


# (keys, lengths, d): seq_kv's shard, a 128-key cache, decode_32k's
# production shard (8 rows, 2048 keys), a ragged one (1000 keys: blocks of
# 512, so each block's last tile holds 8 keys, and rows end mid-tile) and
# d 64
@pytest.mark.parametrize("Sk,lens,d", [
    (8, (0, 1, 8, 5), 128), (128, (0, 1, 128, 57), 128),
    (2048, (2048, 0, 1, 1500), 128),
    (2048, (2048, 0, 1, 1500, 2048, 2047, 640, 33), 128),
    (1000, (1000, 0, 999, 1, 513, 33, 967, 32), 128),
    (2048, (2048, 0, 1, 1500, 2048, 2047, 640, 33), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_partial_mode(cuda, Sk, lens, d, dtype):
    """The partial mode (``return_lse``) on both decode routes: ``out`` in
    f32 within the reference tolerance, ``lse`` within 1e-4 of the plain
    version's, a row of length 0 exactly (0, -inf), the same bits on two
    runs."""
    from repro_torch.kernels.flash_attention import plan_for
    B, Hq, Hkv = len(lens), 16, 8
    q = _decode_q(cuda, B, Hq, d, dtype)
    k, v = _cache_kv(cuda, B, Sk, Hkv, d, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert plan_for(q, k, v).route == (
        "bulk" if dtype == torch.bfloat16 else "split")
    o, lse = ops.flash_attention(q, k, v, causal=False, lengths=lengths,
                                 return_lse=True)
    o2, lse2 = ops.flash_attention(q, k, v, causal=False, lengths=lengths,
                                   return_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=False,
                                             lengths=lengths,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    live, zero = lengths > 0, lengths == 0
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    _close(o[live], o_ref[live], **tol)
    _close(lse[live], lse_ref[live], rtol=0, atol=1e-4)
    assert torch.equal(o[zero], torch.zeros_like(o[zero]))
    assert torch.isneginf(lse[zero]).all()


def _flash_kernels(call, calls):
    """``calls`` runs of ``call`` through the profiler (up to three times:
    it has dropped some events of a run): the flash kernels by name."""
    for _ in range(3):
        counts = _device_kernels(call, calls)
        kernels = {k: n for k, n in counts.items() if "flash" in k}
        if sum(kernels.values()) == calls:
            break
    return kernels


def test_flash_attention_split_route_is_one_launch(cuda):
    """One launch of the bulk kernel a bf16 decode call, in both modes: a
    4096-key cache, and the partial mode at decode_32k's shard."""
    B, Hq, Hkv, d, Sk = 4, 16, 8, 128, 4096
    q = torch.randn(B, Hq, 1, d, device=cuda).to(torch.bfloat16)
    k, v = _cache_kv(cuda, B, Sk, Hkv, d, torch.bfloat16)
    lengths = torch.tensor((4096, 3072, 1024, 1), dtype=torch.int32,
                           device=cuda)
    kernels = _flash_kernels(lambda: ops.flash_attention(
        q, k, v, causal=False, lengths=lengths), 5)
    assert len(kernels) == 1 and "bulk" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 5
    B, Sk = 8, 2048
    q = _decode_q(cuda, B, Hq, d, torch.bfloat16)
    k, v = _cache_kv(cuda, B, Sk, Hkv, d, torch.bfloat16)
    lengths = torch.full((B,), Sk, dtype=torch.int32, device=cuda)
    kernels = _flash_kernels(lambda: ops.flash_attention(
        q, k, v, causal=False, lengths=lengths, return_lse=True), 5)
    assert len(kernels) == 1 and "bulk" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 5


# one query row at other head layouts: all query heads on one KV head (16
# rows of the tensor-core tile, and 32: two head groups), one query head
# a KV head, d 64, no lengths, the causal mask (query 0 sees key 0 only)
@pytest.mark.parametrize("case", [(2, 16, 1, 300, 128, (300, 7), False),
                                  (1, 32, 1, 64, 64, (50,), False),
                                  (3, 4, 4, 1000, 64, (1000, 1, 513), False),
                                  (2, 8, 2, 96, 128, None, False),
                                  (2, 8, 2, 96, 128, (96, 5), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_split_route_head_layouts(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import plan_for
    B, Hq, Hkv, Sk, d, lens, causal = case
    q = _decode_q(cuda, B, Hq, d, dtype)
    k, v = _cache_kv(cuda, B, Sk, Hkv, d, dtype)
    lengths = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=cuda))
    assert plan_for(q, k, v).route == ("bulk" if dtype == torch.bfloat16
                                       else "split")
    o = ops.flash_attention(q, k, v, causal=causal, lengths=lengths)
    torch.cuda.synchronize()
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    _close(o, ref.flash_attention_ref(q, k, v, causal=causal,
                                      lengths=lengths), **tol)


# -- decode steps captured as CUDA graphs -----------------------------------
# The smoke model as it is (f32: the CUDA-core routes) and widened to bf16
# with head dim 64 and group 64 (the decode routes on the tensor cores,
# clusters and dependent launches), CLoQ-quantized on the card.

_GRAPH_MODELS = {"f32": {}, "bf16": dict(dtype=torch.bfloat16, d_model=256,
                                         head_dim=64, d_ff=512)}


def _graph_model(cuda, which):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config("qwen3-1.7b", **_GRAPH_MODELS[which])
    params = init_params(cfg, seed=0, device=cuda)
    calib = [TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=2, seed=0)).next_batch()]
    g = 16 if which == "f32" else 64
    qp, qcfg, _ = quantize_model(params, cfg, calib,
                                 recipe=QuantRecipe.single(
                                     "cloq", QSpec(bits=4, group_size=g,
                                                   rank=8)))
    return qp, dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))


def _graph_registry(qp, ranks=(8, 4)):
    from repro_torch.serve import AdapterRegistry, adapters_from_tree
    from repro_torch.serve.registry import synthesize_adapters
    reg = AdapterRegistry.from_model(qp, capacity=4)
    base = adapters_from_tree(qp)
    for i in range(4):
        reg.register(f"t{i}", synthesize_adapters(base, ranks[i % 2],
                                                  seed=10 + i))
    return reg


_REQS = [(f"t{i % 4}", [3 + i, 7], 6 + i % 3) for i in range(7)]


@pytest.mark.parametrize("which", sorted(_GRAPH_MODELS))
def test_captured_engine_gives_the_eager_tokens(cuda, which):
    """The engine with each rank bucket's step captured gives the eager
    engine's tokens, and counts the same launches."""
    from repro_torch.serve import ServeEngine, run_workload
    qp, qcfg = _graph_model(cuda, which)
    reg = _graph_registry(qp)
    runs = {}
    for graph in (False, True):
        eng = ServeEngine(qp, qcfg, reg, page_size=4, max_len=24,
                          use_kernel=True, graph=graph)
        ops.reset_launch_counts()
        runs[graph] = (run_workload(eng, _REQS), ops.launch_counts(),
                       dict(eng.decodes))
    assert runs[True] == runs[False]
    out, counts, decodes = runs[True]
    assert set(decodes) == {4, 8}
    per = 7 * qcfg.n_layers
    assert counts["dequant_matmul"] == per * sum(decodes.values())
    assert counts["flash_attention"] == qcfg.n_layers * sum(decodes.values())
    assert all(len(out[i]) == _REQS[i][2] for i in range(len(_REQS)))


@pytest.mark.parametrize("which", sorted(_GRAPH_MODELS))
def test_captured_fixed_slots_give_the_eager_tokens(cuda, which):
    from repro_torch.launch import serve
    qp, qcfg = _graph_model(cuda, which)
    runs = {}
    for graph in (False, True):
        ops.reset_launch_counts()
        res = serve.serve_fixed_slots(qp, qcfg, batch=4, cache_len=32,
                                      requests=8, max_new=8, seed=0,
                                      device=cuda, graph=graph,
                                      keep_logits=True)
        runs[graph] = (res, ops.launch_counts())
    (eager, ce), (capt, cc) = runs[False], runs[True]
    assert cc == ce and ce["dequant_matmul"] == 7 * qcfg.n_layers * 16
    assert capt["steps"] == eager["steps"] == 16 and capt["all_finite"]
    for a, b in zip(capt["outputs"], eager["outputs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(capt["logits"]),
                                  np.stack(eager["logits"]))


@pytest.mark.parametrize("which", sorted(_GRAPH_MODELS))
def test_captured_encdec_fixed_slots_give_the_eager_tokens(cuda, which):
    """seamless's smoke model (widened as the others), CLoQ-quantized on
    the card, decoded by the fixed-slot loop against a real encoder
    output, eager and captured: the same tokens and logits, and a step's
    launches, among them the fused kernel over all of ``enc_out``'s rows
    (4 x 32: cross k/v, 2 a layer) inside the captured graph."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream, data_kind
    from repro_torch.launch import serve
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import _encode, init_params
    cfg = get_smoke_config("seamless-m4t-medium", **_GRAPH_MODELS[which])
    params = init_params(cfg, seed=0, device=cuda)
    calib = [TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0,
        kind=data_kind(cfg), enc_len=16, d_model=cfg.d_model)).next_batch()]
    g = 16 if which == "f32" else 64
    qp, qcfg, _ = quantize_model(params, cfg, calib,
                                 recipe=QuantRecipe.single(
                                     "cloq", QSpec(bits=4, group_size=g,
                                                   rank=8)))
    qcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    with torch.no_grad():
        enc_out = _encode(qp, qcfg, torch.randn(
            (4, 32, cfg.d_model), generator=gen, device=cuda))
    runs = {}
    for graph in (False, True):
        ops.reset_launch_counts()
        res = serve.serve_fixed_slots(qp, qcfg, batch=4, cache_len=32,
                                      requests=8, max_new=8, seed=0,
                                      device=cuda, graph=graph,
                                      keep_logits=True, enc_out=enc_out)
        runs[graph] = (res, ops.launch_counts())
    (eager, ce), (capt, cc) = runs[False], runs[True]
    L = qcfg.n_layers
    assert cc == ce == {"dequant_matmul": 9 * L * 16,
                        "dequant_matmul_lora": 2 * L * 16,
                        "flash_attention": L * 16, "gram": 0}
    assert capt["steps"] == eager["steps"] == 16 and capt["all_finite"]
    for a, b in zip(capt["outputs"], eager["outputs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(capt["logits"]),
                                  np.stack(eager["logits"]))


def test_hot_swap_after_capture_reaches_the_next_replay(cuda):
    """A swap written into a rank bucket's stacks after its step was
    captured is seen by the next replay, with no new capture: the tokens
    are those of an eager engine over the swapped registry."""
    from repro_torch.serve import (ServeEngine, adapters_from_tree,
                                   run_workload)
    from repro_torch.serve.registry import synthesize_adapters
    qp, qcfg = _graph_model(cuda, "bf16")
    reg = _graph_registry(qp)
    eng = ServeEngine(qp, qcfg, reg, page_size=4, max_len=24,
                      use_kernel=True, graph=True)
    first = run_workload(eng, [("t0", [5], 6)])[0]
    graph = eng._captured[8].graph
    assert graph is not None
    reg.swap("t0", synthesize_adapters(adapters_from_tree(qp), 8, seed=99))
    after = run_workload(eng, [("t0", [5], 6)])[0]
    assert eng._captured[8].graph is graph
    eager = ServeEngine(qp, qcfg, reg, page_size=4, max_len=24,
                        use_kernel=True, graph=False)
    assert after == run_workload(eager, [("t0", [5], 6)])[0]
    assert after != first


def test_replay_adds_the_captured_launches(cuda):
    from repro_torch.launch.steps import CapturedStep
    x, packed, s, z = _dq_operands(cuda, 4, 256, 128, 4, 64)
    q = torch.randn(1, 2, 1, 64, device=cuda)

    def fn(xin):
        y = ops.dequant_matmul(xin, packed, s, z, bits=4, group_size=64)
        y = ops.dequant_matmul(xin * 2, packed, s, z, bits=4, group_size=64)
        return y, ops.flash_attention(q, q, q, causal=False)

    step = CapturedStep(fn)
    ops.reset_launch_counts()
    eager = step(x)[0].clone()                 # warm-up: runs eagerly
    assert ops.launch_counts()["dequant_matmul"] == 2
    outs = [step(x)[0].clone() for _ in range(3)]   # capture + replays
    assert step.launches["dequant_matmul"] == 2
    assert step.launches["flash_attention"] == 1
    assert ops.launch_counts()["dequant_matmul"] == 8
    assert ops.launch_counts()["flash_attention"] == 4
    for o in outs:
        assert torch.equal(o, eager)
    y = step(x * 0)[0]
    assert not y.any()
    with pytest.raises(ValueError, match="captured"):
        step(x[:2])


def test_capture_failure_raises(cuda):
    """A step that cannot be captured (it synchronizes the host) raises at
    capture, takes back the launches it recorded, and never runs
    eagerly in its place.  It hands back what torch's failed
    ``capture_end`` keeps: the caller's stream, and the graph's memory
    pool (the step allocates 30% of the free memory inside the capture),
    so that the allocator frees its cache again and a block freed with a
    use on a side stream is not held for ever: one allocation of 80% of
    the free memory then succeeds in the same process."""
    import gc
    from repro_torch.launch.steps import CapturedStep
    x, packed, s, z = _dq_operands(cuda, 4, 256, 128, 4, 64)
    calls = []

    def fn(xin):
        calls.append(1)
        buf = torch.empty(work, dtype=torch.uint8, device=cuda)
        y = ops.dequant_matmul(xin, packed, s, z, bits=4, group_size=64)
        return y * float(y.abs().max()) + buf[0]  # a host sync

    torch.cuda.empty_cache()
    work = int(0.3 * torch.cuda.mem_get_info()[0])
    step = CapturedStep(fn)
    step(x)
    ops.reset_launch_counts()
    caller = torch.cuda.current_stream()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    free = torch.cuda.mem_get_info()[0]
    with pytest.raises(RuntimeError):
        step(x)
    assert step.graph is None
    assert ops.launch_counts()["dequant_matmul"] == 0
    assert len(calls) == 2
    assert torch.cuda.current_stream() == caller
    torch.cuda.synchronize()
    gc.collect()
    held = torch.empty(int(0.4 * free), dtype=torch.uint8, device=cuda)
    held.record_stream(torch.cuda.Stream())
    del held
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved + (64 << 20)
    big = torch.empty(int(0.8 * free), dtype=torch.uint8, device=cuda)
    assert big.numel() == int(0.8 * free)
    del big
    torch.cuda.empty_cache()


def _rel_fro(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("method", ["cloq", "gptq", "loftq", "qlora", "rtn"])
def test_batched_engine_matches_sequential_on_the_card(cuda, method):
    """The smoke model quantized on the card by both engines, held to the
    reference's batched-vs-sequential oracle (``tests/test_batched.py``):
    codes equal up to a 0.005 flip fraction, float leaves within 1e-3
    relative Frobenius, ``A @ B^T`` within 1e-3; the random ``A`` of
    gptq/qlora/rtn bit-equal (each site's own generator) with ``B == 0``;
    both clean under the health guards."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.health import HealthReport
    from repro_torch.core.pipeline import quantize_model, to_eager_params
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import tree_paths
    cfg = get_smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device=cuda)
    calib = [TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4, seed=1)).next_batch()]
    recipe = QuantRecipe.single(method, QSpec(bits=4, group_size=16, rank=8))
    flat, reports = {}, {}
    for engine in ("sequential", "batched"):
        reports[engine] = HealthReport()
        qp, qcfg, _ = quantize_model(params, cfg, calib, recipe=recipe,
                                     engine=engine, report=reports[engine])
        flat[engine] = tree_paths(to_eager_params(qp, qcfg))
    torch.cuda.synchronize()
    s, b = flat["sequential"], flat["batched"]
    assert set(s) == set(b)
    assert not reports["sequential"].counts()
    assert not reports["batched"].counts()
    for p in s:
        if p.endswith(".lora_b"):
            continue
        if p.endswith(".lora_a"):
            pb = p[:-len("lora_a")] + "lora_b"
            assert _rel_fro(b[p].float() @ b[pb].float().T,
                            s[p].float() @ s[pb].float().T) <= 1e-3, p
            if method in ("gptq", "qlora", "rtn"):
                assert torch.equal(b[p], s[p]) and not b[pb].any(), p
        elif s[p].dtype == torch.uint8:
            assert float((b[p] != s[p]).float().mean()) <= 5e-3, p
        elif s[p].is_floating_point():
            assert _rel_fro(b[p], s[p]) <= 1e-3, p


def test_streamed_and_serialized_buckets_give_the_same_bits(cuda):
    """``stream=True`` stages bucket k+1 before anything waits on bucket k;
    ``stream=False`` synchronizes after each bucket: the same operations on
    the same inputs, so the same bits on the card."""
    from repro_torch.core.batched import (LayerTask, quantize_layer_batch,
                                          task_key)
    from repro_torch.models.modules import QSpec
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    tasks = []
    for i, (m, n) in enumerate([(256, 128)] * 3 + [(128, 256)] * 2):
        X = torch.randn((512, m), generator=gen, device=cuda)
        tasks.append(LayerTask(f"l{i}", None,
                               torch.randn((m, n), generator=gen,
                                           device=cuda) * 0.02,
                               X.T @ X, task_key(0, i)))
    q = QSpec(bits=4, group_size=64, rank=16)
    for method in ("cloq", "loftq", "rtn"):
        a = quantize_layer_batch(tasks, q, method, stream=True)
        b = quantize_layer_batch(tasks, q, method, stream=False)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            for k in x:
                assert torch.equal(x[k], y[k]), (method, k)


# -- the other configs' kernel shapes, and the MoE decode ---------------------


def _config_linears(name):
    """(K, N) of each quantized 2-D linear of one layer of a ported config
    at its published widths (q, k, v, o and, for dense, gate/up, down)."""
    from repro_torch.configs import get_config
    c = get_config(name)
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    out = {(c.d_model, q), (c.d_model, kv), (q, c.d_model)}
    if c.family == "dense":
        out |= {(c.d_model, c.d_ff), (c.d_ff, c.d_model)}
    return sorted(out)


NEW_CONFIGS = ("qwen3-4b", "codeqwen1.5-7b", "minicpm-2b", "olmoe-1b-7b",
               "qwen3-moe-30b-a3b")
NEW_LINEARS = sorted({kn for c in NEW_CONFIGS for kn in _config_linears(c)})


def _randn(gen, *shape):
    """N(0, 1) f32 from ``gen``: these tests draw from their own generator,
    as the default one cannot be used after a capture that raised
    (``test_capture_failure_raises``)."""
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.fixture
def gen(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("K,N", NEW_LINEARS)
def test_new_config_linears_on_the_decode_and_train_routes(gen, K, N):
    """Each linear of the new configs at full width, bf16, 4-bit, group
    64: the decode kernel at 4 rows on the tensor-core route (K split over
    a cluster; CodeQwen's K = 13440 is 210 groups) and the fused kernel at
    1024 rows, rank 64, on the wgmma route, both within the bf16
    tolerance of their plain versions."""
    from repro_torch.kernels.dequant_matmul import lora_plan_for, plan_for
    codes, s, z = quantize_int(_randn(gen, K, N) * 0.02, 4, 64)
    packed = pack_codes(codes, 4)
    x = _randn(gen, 4, K).to(torch.bfloat16)
    assert plan_for(x, packed, s, z, 64).route == "mma"
    y = ops.dequant_matmul(x, packed, s, z, bits=4, group_size=64)
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=4, group_size=64),
           **_tol(torch.bfloat16))
    xt = _randn(gen, 1024, K).to(torch.bfloat16)
    a = (_randn(gen, K, 64) / K ** 0.5).to(torch.bfloat16)
    b = (_randn(gen, N, 64) * 0.1).to(torch.bfloat16)
    assert lora_plan_for(xt, packed, s, z, a, b, 64).route == "wgmma"
    y = ops.dequant_matmul_lora(xt, packed, s, z, a, b, bits=4,
                                group_size=64)
    _close(y, ref.dequant_matmul_lora_ref(xt, packed, s, z, a, b, bits=4,
                                          group_size=64),
           **_tol(torch.bfloat16))


@pytest.mark.parametrize("Hq,Hkv,d", [(16, 16, 128), (32, 32, 128),
                                      (36, 36, 64), (32, 4, 128),
                                      (32, 8, 128)])
def test_new_config_decode_attention(gen, Hq, Hkv, d):
    """Decode attention at the new configs' heads (MHA, GQA group 8, head
    dim 64) through the cache's transpose: the bulk route in bf16 (q scaled
    by 4, as chip_smoke's decode cases), the split route in f32."""
    from repro_torch.kernels.flash_attention import plan_for
    lengths = torch.tensor([128, 97, 40, 1], dtype=torch.int32,
                           device=gen.device)
    for dtype, route, tol in ((torch.bfloat16, "bulk", 5e-2),
                              (torch.float32, "split", 1e-4)):
        q = (_randn(gen, 4, 1, Hq, d) * 4).to(dtype)
        k = _randn(gen, 4, 128, Hkv, d).to(dtype)
        v = _randn(gen, 4, 128, Hkv, d).to(dtype)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        assert plan_for(q, k, v).route == route
        o = ops.flash_attention(q, k, v, causal=False, lengths=lengths)
        _close(o, ref.flash_attention_ref(q, k, v, causal=False,
                                          lengths=lengths),
               rtol=tol, atol=tol)


@pytest.mark.parametrize("T,D", [(1024, 2304), (1024, 2560), (1024, 4096),
                                 (1024, 5760), (1024, 9728), (1024, 13440),
                                 (160, 2048), (160, 1024), (20, 768)])
def test_new_config_grams(gen, T, D):
    """The Gram at the new configs' calibration widths and at MoE expert
    slices (C = 160 rows at 8 x 128 tokens, top-8 of 64): the wgmma route,
    exactly symmetric, within the f32 tolerance (exact bf16 products)."""
    from repro_torch.kernels.gram import plan_for
    x = _randn(gen, T, D).to(torch.bfloat16)
    assert plan_for(x).route == "wgmma"
    h = ops.gram(x)
    assert torch.equal(h, h.T)
    _close(h, ref.gram_ref(x), rtol=1e-4, atol=1e-2)


def _moe_model(cuda):
    """The OLMoE smoke model widened to bf16 with head dim 64 and group 64
    (the decode routes on the tensor cores), CLoQ-quantized on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config("olmoe-1b-7b", dtype=torch.bfloat16, d_model=256,
                           head_dim=64, d_ff_expert=128, n_experts=8)
    params = init_params(cfg, seed=0, device=cuda)
    calib = [TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=2, seed=0)).next_batch()]
    qp, qcfg, _ = quantize_model(params, cfg, calib,
                                 recipe=QuantRecipe.single(
                                     "cloq", QSpec(bits=4, group_size=64,
                                                   rank=8)))
    return qp, dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))


def test_captured_moe_engine_gives_the_eager_tokens(cuda):
    """The MoE model served by the engine with each rank bucket's decode
    captured gives the eager engine's tokens (the dispatch, the capacity
    drops and the combine included), with 4 attention linears and one
    attention call a layer a decode through the kernels."""
    from repro_torch.serve import ServeEngine, run_workload
    qp, qcfg = _moe_model(cuda)
    reg = _graph_registry(qp)
    assert sorted(reg.sites()) == ["attn.k", "attn.o", "attn.q", "attn.v"]
    runs = {}
    for graph in (False, True):
        eng = ServeEngine(qp, qcfg, reg, page_size=4, max_len=24,
                          use_kernel=True, graph=graph)
        ops.reset_launch_counts()
        runs[graph] = (run_workload(eng, _REQS), ops.launch_counts(),
                       dict(eng.decodes))
    assert runs[True] == runs[False]
    out, counts, decodes = runs[True]
    assert counts["dequant_matmul"] == 4 * qcfg.n_layers * sum(
        decodes.values())
    assert counts["flash_attention"] == qcfg.n_layers * sum(decodes.values())
    assert all(len(out[i]) == _REQS[i][2] for i in range(len(_REQS)))


def test_moe_dispatch_captures_without_a_host_sync(cuda):
    """``moe_apply`` (route, sort, capacity buffer, experts, combine) on a
    quantized expert stack captured as a CUDA graph: the capture succeeds
    (a host sync would raise) and replays give the eager bits, which two
    eager runs also give (no atomics in the combine)."""
    from repro_torch.launch.steps import CapturedStep
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import layer_params
    qp, qcfg = _moe_model(cuda)
    tree = layer_params(qp["blocks"]["moe"], 0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    x = _randn(gen, 4, 1, qcfg.d_model).to(torch.bfloat16)
    with torch.no_grad():
        eager = moe_apply(tree, qcfg.moe_cfg(), x, qspec=qcfg.quant)[0]
        again = moe_apply(tree, qcfg.moe_cfg(), x, qspec=qcfg.quant)[0]
        step = CapturedStep(lambda xin: moe_apply(tree, qcfg.moe_cfg(), xin,
                                                  qspec=qcfg.quant)[0])
        outs = [step(x).clone() for _ in range(3)]
    assert step.graph is not None
    assert torch.equal(eager, again)
    for o in outs:
        assert torch.equal(o, eager)


# -- the SSM and hybrid families (Mamba2-370M, Zamba2-7B) ---------------------

@pytest.mark.parametrize("K,N", [(1024, 32), (3584, 112), (1024, 256),
                                 (14336, 3584)])
def test_ssm_decode_linears_on_the_tensor_core_route(gen, K, N):
    """The decode kernel at 4 rows, bf16, 4-bit, group 64, at the SSM
    families' new shapes: output widths below one 128-column tile (Mamba2's
    dt_proj N = 32, Zamba2's N = 112, not a multiple of 64; bc_proj N =
    256) and Zamba2's mlp.down K = 14336 (224 groups), on its planned
    tensor-core route within the bf16 tolerance."""
    from repro_torch.kernels.dequant_matmul import plan_for
    codes, s, z = quantize_int(_randn(gen, K, N) * 0.02, 4, 64)
    packed = pack_codes(codes, 4)
    x = _randn(gen, 4, K).to(torch.bfloat16)
    assert plan_for(x, packed, s, z, 64).route == "mma"
    y = ops.dequant_matmul(x, packed, s, z, bits=4, group_size=64)
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=4, group_size=64),
           **_tol(torch.bfloat16))


@pytest.mark.parametrize("K,N,r", [(1024, 32, 32), (3584, 112, 64)])
def test_ssm_fused_lora_on_narrow_outputs(gen, K, N, r):
    """The fused kernel at 1024 rows on a partial column tile: Mamba2's
    dt_proj (N = 32 at the rank CLoQ cuts to N) and Zamba2's (N = 112), on
    the planned wgmma route within the bf16 tolerance."""
    from repro_torch.kernels.dequant_matmul import lora_plan_for
    codes, s, z = quantize_int(_randn(gen, K, N) * 0.02, 4, 64)
    packed = pack_codes(codes, 4)
    xt = _randn(gen, 1024, K).to(torch.bfloat16)
    a = (_randn(gen, K, r) / K ** 0.5).to(torch.bfloat16)
    b = (_randn(gen, N, r) * 0.1).to(torch.bfloat16)
    assert lora_plan_for(xt, packed, s, z, a, b, 64).route == "wgmma"
    y = ops.dequant_matmul_lora(xt, packed, s, z, a, b, bits=4,
                                group_size=64)
    _close(y, ref.dequant_matmul_lora_ref(xt, packed, s, z, a, b, bits=4,
                                          group_size=64),
           **_tol(torch.bfloat16))


def test_captured_mamba_decode_gives_the_eager_bits(cuda):
    """``mamba_decode`` on a quantized Mamba block captured as a CUDA graph
    and replayed: each replay gives the eager step's output bits and leaves
    the eager step's conv windows and state, written in place into the
    cache tensors the graph captured."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.steps import CapturedStep
    from repro_torch.models.modules import QSpec
    from repro_torch.models.ssm import mamba_decode, mamba_init_cache
    from repro_torch.models.transformer import init_params, layer_params
    cfg = get_smoke_config("mamba2-370m", dtype=torch.bfloat16, d_model=256,
                           ssm_head_dim=64, ssm_state=64)
    params = init_params(cfg, seed=0, device=cuda)
    calib = [TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=2, seed=0)).next_batch()]
    qp, qcfg, _ = quantize_model(params, cfg, calib, recipe=QuantRecipe.single(
        "cloq", QSpec(bits=4, group_size=64, rank=8)))
    q = QSpec(bits=4, group_size=64, rank=8, use_kernel=True)
    p = layer_params(qp["blocks"], 0)["mamba"]
    scfg = qcfg.ssm_cfg()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    xs = [_randn(gen, 4, 1, cfg.d_model).to(torch.bfloat16)
          for _ in range(4)]
    eager_cache = mamba_init_cache(scfg, 4, device=cuda)
    graph_cache = mamba_init_cache(scfg, 4, device=cuda)
    step = CapturedStep(lambda x: mamba_decode(p, scfg, x, graph_cache,
                                               qspec=q)[0])
    with torch.no_grad():
        for x in xs:
            want = mamba_decode(p, scfg, x, eager_cache, qspec=q)[0]
            got = step(x)
            assert torch.equal(got, want)
            for k in ("conv_x", "conv_bc", "state"):
                assert torch.equal(graph_cache[k], eager_cache[k]), k
    assert step.graph is not None and step.launches["dequant_matmul"] == 5
    assert bool(eager_cache["state"].abs().sum() > 0)


# -- slice 10: the mixed-bit sites of an allocated plan -----------------------


@pytest.mark.parametrize("rank", [0, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 1024])
def test_three_bit_site_one_code_a_byte(cuda, rank, dtype, M):
    """A 3-bit site, its codes stored one a byte (the kernels' 8-bit
    layout, as ``linear_apply`` reads it), at rank 0 and 64:
    ``dequant_matmul`` (decode rows) and ``dequant_matmul_lora`` (any
    rows) against their plain versions, the weights at the other LoRA
    cases' scale (the plain version rounds them to bf16 once dequantized:
    at unit scale that alone moves small outputs past 2e-2)."""
    from repro_torch.models.modules import packed_bits
    K, N, g = 2048, 1024, 64
    x, packed, s, z, a, b = _lora_case(cuda, M, K, N, g, 3, rank, dtype)
    assert packed.shape == (K, N) and int(packed.max()) <= 7
    assert packed_bits(packed.shape[0], K) == 8
    y = ops.dequant_matmul(x, packed, s, z, bits=8, group_size=g)
    yl = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=8, group_size=g)
    torch.cuda.synchronize()
    _close(y, ref.dequant_matmul_ref(x, packed, s, z, bits=8, group_size=g),
           **_tol(dtype))
    _close(yl, ref.dequant_matmul_lora_ref(x, packed, s, z, a, b, bits=8,
                                           group_size=g), **_tol(dtype))


def test_evaluate_layer_batch_on_the_card_matches_the_cpu(cuda):
    """The sensitivity sweep's proxy errors of the same tasks (every
    method, 2-4 bits, ranks 0 and 8) on the card and on the CPU, within
    1e-3 relative, the calibrated objective's limit of the engines'
    oracle; the random ``A`` of gptq, qlora and rtn meets ``B = 0``."""
    from repro_torch.core import batched as tb
    from repro_torch.core.recipe import SiteSpec
    from repro_torch.models.modules import QSpec
    rng = np.random.default_rng(0)
    m, n = 128, 96
    cpu, card = [], []
    for method, bits, rank in (("cloq", 2, 8), ("cloq", 3, 0),
                               ("gptq", 4, 8), ("loftq", 2, 8),
                               ("qlora", 4, 8), ("rtn", 3, 0)):
        spec = SiteSpec(method, QSpec(bits=bits, group_size=32, rank=rank,
                                      method=method))
        for _ in range(3):
            W = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
            X = rng.normal(size=(512, m)).astype(np.float32)
            H = torch.from_numpy(X.T @ X)
            key = tb.task_key(0, len(cpu))
            cpu.append(tb.LayerTask(f"{method}{len(cpu)}", None, W, H, key,
                                    site=spec))
            card.append(tb.LayerTask(cpu[-1].path, None, W.to(cuda),
                                     H.to(cuda), key, site=spec))
    want = tb.evaluate_layer_batch(cpu)
    got = tb.evaluate_layer_batch(card)
    for t, a, b in zip(cpu, got, want):
        assert abs(a - b) <= 1e-3 * abs(b), (t.path, a, b)


def _bucket_diff(got: dict, want: dict, W, H, m: int, g: int) -> dict:
    """One slice's leaves against another run's, in the terms of the
    reference's engine oracle: code flips, scales, zeros, ``A @ B^T`` and
    the calibrated objective ``gram_error`` (relative)."""
    from repro_torch.core.optq import gram_error
    from repro_torch.core.quantizer import dequantize_int, unpack_codes

    def recon(lv):
        codes = unpack_codes(lv["qcodes"], 4, m)
        return codes, (dequantize_int(codes, lv["scales"], lv["zeros"], g)
                       + lv["lora_a"] @ lv["lora_b"].T)

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    cg, rg = recon(got)
    cw, rw = recon(want)
    eg, ew = gram_error(H, W - rg), gram_error(H, W - rw)
    return {"code_flips": float((cg != cw).float().mean()),
            "scales": rel(got["scales"], want["scales"]),
            "zeros": rel(got["zeros"], want["zeros"]),
            "lora_ab": rel(got["lora_a"] @ got["lora_b"].T,
                           want["lora_a"] @ want["lora_b"].T),
            "gram_error": abs(eg - ew) / ew}


def test_sharded_cloq_bucket_on_two_ranks_matches_unsharded(cuda, tmp_path):
    """2 gloo ranks on ``cuda:0`` run one CLoQ bucket at Qwen3-1.7B's gate
    shape (2048 x 6144, L = 2; 4-bit, group 64, rank 64) column-sharded;
    the gathered leaves agree with the unsharded bucket on the card under
    the engines' limits: scales, zeros and ``gram_error`` within 1e-3,
    codes within 0.005 or twice what one ulp of the Gram moves on the
    unsharded bucket, ``A @ B^T`` within 5e-3 or twice that ulp's."""
    import torch_dist_worker
    from repro_torch.core import batched as tb
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.modules import QSpec
    gen = torch.Generator().manual_seed(7)
    L, m, n, T = 2, 2048, 6144, 1024
    Ws = torch.randn((L, m, n), generator=gen) * 0.02
    Xs = torch.randn((L, T, m), generator=gen)
    Hs = Xs.mT @ Xs
    qs = dict(bits=4, group_size=64, rank=64)
    torch.save({"Ws": Ws, "Hs": Hs, "qs": qs}, tmp_path / "bucket.pt")
    spawn_ranks(torch_dist_worker.cuda_bucket, 2, backend="gloo",
                device="cuda", args=(str(tmp_path),),
                store_dir=str(tmp_path))
    got = torch.load(tmp_path / "sharded.pt")
    Ws, Hs = Ws.to(cuda), Hs.to(cuda)

    def unsharded(H):
        tasks = [tb.LayerTask(f"l{i}", None, Ws[i], H[i], tb.task_key(0, i))
                 for i in range(L)]
        return tb.quantize_layer_batch(tasks, QSpec(**qs), "cloq")

    want = unsharded(Hs)
    nudged = unsharded(torch.nextafter(Hs, torch.full_like(Hs,
                                                           float("inf"))))
    for i in range(L):
        g = {k: v.to(cuda) for k, v in got[i].items()}
        d = _bucket_diff(g, want[i], Ws[i], Hs[i], m, 64)
        nd = _bucket_diff(nudged[i], want[i], Ws[i], Hs[i], m, 64)
        assert d["code_flips"] <= max(0.005, 2 * nd["code_flips"]), (d, nd)
        assert d["lora_ab"] <= max(5e-3, 2 * nd["lora_ab"]), (d, nd)
        for k in ("scales", "zeros", "gram_error"):
            assert d[k] <= 1e-3, (k, d)


# -- the compile cache of the kernel libraries -------------------------------


def test_kernel_library_cache_hit_miss_and_corrupt(cuda, tmp_path,
                                                   monkeypatch):
    """The real build of ``gram.cu`` through a cache of its own: a miss
    (one ``nvcc``), a hit in a second instance, then a copy of the stored
    library cut to half its bytes is warned about, deleted, rebuilt and
    launches.  The process's own cache (``kernels.build``) is untouched."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels import build
    src = build.CSRC / "gram.cu"
    syms = build.entry_symbols("gram.cu")
    first = CompileCache(tmp_path / "cache")
    lib = first.load(src, build.NVCC_FLAGS, syms)
    assert (first.hits, first.misses, first.corrupt) == (0, 1, 0)
    assert first.env["capability"] == list(
        torch.cuda.get_device_capability())
    assert "release" in first.env["nvcc"]
    again = CompileCache(tmp_path / "cache")
    assert again.load(src, build.NVCC_FLAGS, syms).gram_launch
    assert (again.hits, again.misses) == (1, 0)
    # the cut goes to a copy: the stored file is mapped into this process
    shutil.copytree(tmp_path / "cache", tmp_path / "cut")
    stored = first.path(src, build.NVCC_FLAGS)
    cut = tmp_path / "cut" / stored.name
    with open(cut, "r+b") as f:
        f.truncate(cut.stat().st_size // 2)
    third = CompileCache(tmp_path / "cut")
    with pytest.warns(RuntimeWarning, match="corrupt kernel library"):
        rebuilt = third.load(src, build.NVCC_FLAGS, syms)
    assert (third.hits, third.misses, third.corrupt) == (0, 1, 1)
    third._check_record(cut)
    assert lib.gram_launch
    monkeypatch.setattr(build, "load", lambda source: rebuilt)
    x = torch.randn((256, 128), device=cuda)
    _close(ops.gram(x), ref.gram_ref(x), rtol=1e-4, atol=1e-2)
