"""Port parity for the kernel modules.

On the CPU: the plain versions in ``repro_torch.kernels.ref`` against the
JAX package's kernels run as ``tests/test_kernels.py`` runs them (Pallas
in interpret mode), with that file's tolerances — dequant-matmul (fused
LoRA variant included) 2e-4 in f32 and 2e-2 in bf16
(``test_kernels.py:12-14``), flash attention 1e-4 in f32 and 5e-2 in bf16
(``test_kernels.py:85-98``), gram as ``test_kernels.py::test_gram`` — the
``ops`` wrappers' CPU dispatch, and the differentiable wrappers' backward
against autograd through the plain versions.  The CUDA kernels themselves
are held against the plain versions in ``tests/test_torch_cuda.py``, on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref
from tests.torch_parity import TOL_BF16, TOL_F32, to_np

RNG = np.random.default_rng(0)


def _tol(dtype):
    return TOL_BF16 if dtype == "bf16" else TOL_F32


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _packed(K, N, bits, g):
    W = jnp.asarray(RNG.normal(size=(K, N)), jnp.float32)
    codes, s, z = jq.quantize_int(W, bits, g)
    return (np.array(jq.pack_codes(codes, bits)), np.array(s), np.array(z))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128, 128, 64), (5, 48, 40, 16)])
def test_dequant_matmul_ref_matches_jax(bits, dtype, shape):
    M, K, N, g = shape
    packed, s, z = _packed(K, N, bits, g)
    x = RNG.normal(size=(M, K)).astype(np.float32)
    yj = jops.dequant_matmul(jnp.asarray(x, _jdt(dtype)), jnp.asarray(packed),
                             jnp.asarray(s), jnp.asarray(z), bits=bits,
                             group_size=g)
    yt = ref.dequant_matmul_ref(torch.from_numpy(x).to(_tdt(dtype)),
                                torch.from_numpy(packed),
                                torch.from_numpy(s), torch.from_numpy(z),
                                bits=bits, group_size=g)
    assert yt.dtype == _tdt(dtype) and yt.shape == (M, N)
    np.testing.assert_allclose(to_np(yt), to_np(yj), **_tol(dtype))


# (B, Hq, Hkv, Sq, Sk, d, causal, lengths)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 16, True, (64, 23)),
    (2, 4, 2, 64, 64, 16, False, (40, 1)),
    (4, 16, 8, 1, 32, 16, False, (32, 17, 5, 1)),
    (1, 2, 1, 128, 128, 32, True, None),
    (1, 4, 4, 32, 96, 16, True, (96,)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_ref_matches_jax(case):
    B, Hq, Hkv, Sq, Sk, d, causal, lens = case
    q = RNG.normal(size=(B, Hq, Sq, d)).astype(np.float32)
    k = RNG.normal(size=(B, Hkv, Sk, d)).astype(np.float32)
    v = RNG.normal(size=(B, Hkv, Sk, d)).astype(np.float32)
    lj = None if lens is None else jnp.asarray(lens, jnp.int32)
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    oj = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, lengths=lj, interpret=True)
    ot = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 lengths=lt)
    np.testing.assert_allclose(to_np(ot), to_np(oj), rtol=1e-4, atol=1e-4)


def test_flash_attention_ref_matches_jax_bf16():
    B, Hq, Hkv, S, d = 1, 4, 2, 128, 64
    q, k, v = (RNG.normal(size=s).astype(np.float32)
               for s in ((B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    oj = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                interpret=True)
    ot = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(ot), to_np(oj), rtol=5e-2, atol=5e-2)


NO_LAUNCHES = {"dequant_matmul": 0, "dequant_matmul_lora": 0,
               "flash_attention": 0, "gram": 0}


def test_ops_dispatch_cpu_takes_plain_version():
    packed, s, z = _packed(64, 32, 4, 16)
    x = torch.from_numpy(RNG.normal(size=(3, 64)).astype(np.float32))
    args = (torch.from_numpy(packed), torch.from_numpy(s),
            torch.from_numpy(z))
    ops.reset_launch_counts()
    assert torch.equal(ops.dequant_matmul(x, *args, bits=4, group_size=16),
                       ref.dequant_matmul_ref(x, *args, bits=4,
                                              group_size=16))
    q = torch.randn(2, 4, 1, 16)
    k = torch.randn(2, 2, 8, 16)
    lengths = torch.tensor([8, 3], dtype=torch.int32)
    assert torch.equal(
        ops.flash_attention(q, k, k, causal=False, lengths=lengths),
        ref.flash_attention_ref(q, k, k, causal=False, lengths=lengths))
    assert ops.launch_counts() == NO_LAUNCHES


class _OnDevice:
    """Stands in for a tensor on a device with no kernel and no plain
    version (no such tensor can be made on this host)."""

    def __init__(self, kind: str):
        self.device = torch.device(kind)
        self.requires_grad = False

    def reshape(self, *shape):
        return self

    @property
    def shape(self):
        return (2, 64)


def test_ops_rejects_other_devices():
    """A tensor on neither the CPU, a CUDA card nor the meta device (the
    dry run's shapes) has no version to run: each wrapper raises."""
    for kind in ("xla", "mps"):
        x = _OnDevice(kind)
        with pytest.raises(ValueError, match="device"):
            ops.dequant_matmul(x, x, x, x, bits=4, group_size=16)
        with pytest.raises(ValueError, match="device"):
            ops.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="device"):
            ops.gram(x)
        with pytest.raises(ValueError, match="device"):
            ops.dequant_matmul_lora(x, x, x, x, x, x, bits=4, group_size=16)


def test_ops_meta_tensors_take_the_shape_path():
    """Meta tensors (the dry run) take the plain versions' shapes and
    dtypes through every wrapper, the partial mode's lse too; nothing is
    launched or computed."""
    m = dict(device="meta")
    x = torch.empty(3, 64, **m)
    packed = torch.empty(32, 48, dtype=torch.uint8, **m)
    s = torch.empty(4, 48, **m)
    ops.reset_launch_counts()
    y = ops.dequant_matmul(x, packed, s, s, bits=4, group_size=16)
    assert y.shape == (3, 48) and y.device.type == "meta"
    a, b = torch.empty(64, 8, **m), torch.empty(48, 8, **m)
    assert ops.dequant_matmul_lora(x, packed, s, s, a, b, bits=4,
                                   group_size=16).shape == (3, 48)
    assert ops.gram(x).shape == (64, 64)
    q, k = torch.empty(2, 4, 1, 16, **m), torch.empty(2, 2, 8, 16, **m)
    lengths = torch.empty(2, dtype=torch.int32, **m)
    assert ops.flash_attention(q, k, k, causal=False,
                               lengths=lengths).shape == (2, 4, 1, 16)
    o, lse = ops.flash_attention(q, k, k, causal=False, lengths=lengths,
                                 return_lse=True)
    assert o.shape == (2, 4, 1, 16) and lse.shape == (2, 4, 1)
    assert lse.dtype == torch.float32
    assert ops.launch_counts() == NO_LAUNCHES


# the partial mode's halves: (B, Hq, Hkv, Sk, d, lengths); a length of 0
# in one half is a row whose keys all lie in the other
PARTIAL_CASES = [
    (4, 16, 8, 32, 16, (32, 17, 5, 1)),
    (2, 4, 4, 64, 32, (64, 20)),
    (3, 6, 2, 16, 12, (1, 16, 9)),
]


def _combine(parts):
    """The distributed softmax's combine (``parallel.combine_softmax``)
    of partials ``(out, lse)`` over one process: max, weights, sum."""
    outs = torch.stack([o.float() for o, _ in parts])
    lses = torch.stack([lse for _, lse in parts])
    m = lses.max(0).values
    w = torch.exp(lses - m)
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_flash_attention_partial_halves_match_jax(case, dtype):
    """The plain partial version (``return_lse``) on each half of a key
    range, combined by the distributed softmax, equals the JAX kernel
    (Pallas in interpret mode) on the whole range: 1e-4 in f32, 5e-2 in
    bf16.  The halves' lengths are each row's valid keys in them, 0 where
    a row has none."""
    B, Hq, Hkv, Sk, d, lens = case
    q = RNG.normal(size=(B, Hq, 1, d)).astype(np.float32)
    k = RNG.normal(size=(B, Hkv, Sk, d)).astype(np.float32)
    v = RNG.normal(size=(B, Hkv, Sk, d)).astype(np.float32)
    oj = jflash(*(jnp.asarray(a, _jdt(dtype)) for a in (q, k, v)),
                causal=False, lengths=jnp.asarray(lens, jnp.int32),
                interpret=True)
    qt, kt, vt = (torch.from_numpy(a).to(_tdt(dtype)) for a in (q, k, v))
    half = Sk // 2
    lt = torch.tensor(lens, dtype=torch.int32)
    parts = []
    for lo in (0, half):
        n = (lt - lo).clamp(0, half).to(torch.int32)
        o, lse = ref.flash_attention_ref(
            qt, kt[:, :, lo:lo + half], vt[:, :, lo:lo + half],
            causal=False, lengths=n, return_lse=True)
        assert o.dtype == lse.dtype == torch.float32
        parts.append((o, lse))
    got = _combine(parts)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), to_np(oj), **tol)
    assert any(int(n) == 0 for n in (lt - half).clamp(0, half)) or \
        any(int(n) == 0 for n in lt.clamp(0, half))


def test_flash_attention_partial_zero_length_row():
    """A row with no valid key gives out 0 and lse -inf (the plain version
    and the ``ops`` wrapper on the CPU); the other rows are the full
    mode's, with lse the log-sum-exp of their scaled logits."""
    q = torch.randn(3, 4, 1, 8, dtype=torch.float64).float()
    k = torch.randn(3, 2, 6, 8)
    v = torch.randn(3, 2, 6, 8)
    lengths = torch.tensor([0, 6, 2], dtype=torch.int32)
    o, lse = ops.flash_attention(q, k, v, causal=False, lengths=lengths,
                                 return_lse=True)
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1:]).all()
    full = ref.flash_attention_ref(q[1:], k[1:], v[1:], causal=False,
                                   lengths=lengths[1:])
    torch.testing.assert_close(o[1:], full, rtol=1e-5, atol=1e-6)
    kk = k.repeat_interleave(2, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk) / 8 ** 0.5
    want = torch.stack([torch.logsumexp(logits[1, ..., :6], -1),
                        torch.logsumexp(logits[2, ..., :2], -1)])
    torch.testing.assert_close(lse[1:], want, rtol=1e-6, atol=1e-6)


# gram: the JAX kernel's tolerances (tests/test_kernels.py::test_gram),
# f32 rtol 1e-4 / atol 1e-2, bf16 rtol 2e-2 / atol 2e-1.  (256, 128) runs
# the Pallas body (D % 128 = 0, T % 8 = 0); (37, 50) takes the JAX
# wrapper's plain fallback.
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 128), (37, 50)])
def test_gram_ref_matches_jax(dtype, shape):
    T, D = shape
    x = RNG.normal(size=(T, D)).astype(np.float32)
    hj = jops.gram(jnp.asarray(x, _jdt(dtype)))
    ht = ref.gram_ref(torch.from_numpy(x).to(_tdt(dtype)))
    assert ht.dtype == torch.float32 and ht.shape == (D, D)
    tol = (dict(rtol=2e-2, atol=2e-1) if dtype == "bf16"
           else dict(rtol=1e-4, atol=1e-2))
    np.testing.assert_allclose(to_np(ht), to_np(hj), **tol)


# dequant_matmul_lora: M % 8 = 0 and N % 128 = 0 run the Pallas body of
# the fused kernel; the ragged case takes the JAX wrapper's plain
# fallback.  Tolerances as dequant_matmul's (test_kernels.py:12-14).
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rank", [8, 64])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(16, 256, 128, 64), (5, 48, 40, 16)])
def test_dequant_matmul_lora_ref_matches_jax(dtype, rank, bits, shape):
    M, K, N, g = shape
    packed, s, z = _packed(K, N, bits, g)
    x = RNG.normal(size=(M, K)).astype(np.float32)
    a = (RNG.normal(size=(K, rank)) * 0.1).astype(np.float32)
    b = (RNG.normal(size=(N, rank)) * 0.1).astype(np.float32)
    jd, td = _jdt(dtype), _tdt(dtype)
    yj = jops.dequant_matmul(jnp.asarray(x, jd), jnp.asarray(packed),
                             jnp.asarray(s), jnp.asarray(z), bits=bits,
                             group_size=g, lora_a=jnp.asarray(a, jd),
                             lora_b=jnp.asarray(b, jd))
    yt = ref.dequant_matmul_lora_ref(
        torch.from_numpy(x).to(td), torch.from_numpy(packed),
        torch.from_numpy(s), torch.from_numpy(z),
        torch.from_numpy(a).to(td), torch.from_numpy(b).to(td), bits=bits,
        group_size=g)
    assert yt.dtype == td and yt.shape == (M, N)
    np.testing.assert_allclose(to_np(yt), to_np(yj), **_tol(dtype))


def _lora_operands(M=6, K=64, N=40, r=8, bits=4, g=16, dtype=torch.float32):
    packed, s, z = _packed(K, N, bits, g)
    x = torch.from_numpy(RNG.normal(size=(2, M // 2, K)).astype(np.float32))
    a = torch.from_numpy((RNG.normal(size=(K, r)) * 0.1).astype(np.float32))
    b = torch.from_numpy((RNG.normal(size=(N, r)) * 0.1).astype(np.float32))
    return (x.to(dtype), torch.from_numpy(packed), torch.from_numpy(s),
            torch.from_numpy(z), a.to(dtype), b.to(dtype))


def test_ops_dispatch_cpu_new_wrappers_take_plain_version():
    ops.reset_launch_counts()
    x = torch.from_numpy(RNG.normal(size=(2, 5, 24)).astype(np.float32))
    assert torch.equal(ops.gram(x), ref.gram_ref(x.reshape(10, 24)))
    xb = x.to(torch.bfloat16)
    assert torch.equal(ops.gram(xb), ref.gram_ref(xb.reshape(10, 24)))
    x, packed, s, z, a, b = _lora_operands()
    y = ops.dequant_matmul_lora(x, packed, s, z, a, b, bits=4, group_size=16)
    assert y.shape == (2, 3, 40)
    assert torch.equal(y, ref.dequant_matmul_lora_ref(
        x, packed, s, z, a, b, bits=4, group_size=16))
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_lora_function_grads_match_autograd(dtype):
    """The Function's hand-written backward against autograd through the
    plain version: f32 within 1e-5 (same products, other summation
    order); bf16 within 2e-2 (the plain version rounds each of the two
    paths' dx to bf16 before adding them, the Function adds in f32)."""
    x, packed, s, z, a, b = _lora_operands(dtype=dtype)
    g = torch.from_numpy(RNG.normal(size=(2, 3, 40)).astype(np.float32))
    g = g.to(dtype)
    grads = []
    for fn in (ops.dequant_matmul_lora, ref.dequant_matmul_lora_ref):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        y = fn(xs, packed, s, z, as_, bs, bits=4, group_size=16)
        grads.append(torch.autograd.grad(y, (xs, as_, bs), g))
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-5))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_dequant_matmul_function_grad_matches_autograd():
    x, packed, s, z, _, _ = _lora_operands()
    g = torch.from_numpy(RNG.normal(size=(2, 3, 40)).astype(np.float32))
    dx = []
    for fn in (ops.dequant_matmul, ref.dequant_matmul_ref):
        xs = x.clone().requires_grad_(True)
        y = fn(xs, packed, s, z, bits=4, group_size=16)
        dx.append(torch.autograd.grad(y, xs, g)[0])
    np.testing.assert_allclose(to_np(dx[0]), to_np(dx[1]), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_take_the_function_only_when_a_gradient_is_asked():
    """Without a gradient (decode) the wrappers call the forward directly;
    with one, the autograd Function carries it."""
    from torch.autograd.function import BackwardCFunction
    x, packed, s, z, a, b = _lora_operands()
    for name, rest in (("dequant_matmul", ()), ("dequant_matmul_lora", (a, b))):
        fn = getattr(ops, name)
        assert fn(x, packed, s, z, *rest, bits=4, group_size=16).grad_fn \
            is None
        xs = x.clone().requires_grad_(True)
        with torch.no_grad():
            assert fn(xs, packed, s, z, *rest, bits=4,
                      group_size=16).grad_fn is None
        y = fn(xs, packed, s, z, *rest, bits=4, group_size=16)
        assert isinstance(y.grad_fn, BackwardCFunction)
    y = ops.dequant_matmul_lora(x, packed, s, z, a.clone().requires_grad_(),
                                b, bits=4, group_size=16)
    assert isinstance(y.grad_fn, BackwardCFunction)


# the fused kernel's route and tiling, a plain function of the shape: every
# Qwen3-1.7B linear at the training batch's 1024 rows takes the TMA + wgmma
# kernel with its persistent blocks filling an H100's 132 SMs (the k/v
# projections in 128 tiles of 128 x 64); what TMA cannot address, and
# groups that are not whole 64-row stages, take the mma.sync kernel where
# the group is a multiple of 8 (else the CUDA-core one), and f32 the
# CUDA-core one
H100_SMS = 132


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 1024), (2048, 6144),
                                 (6144, 2048)])
def test_lora_plan_qwen_linears_take_wgmma(K, N):
    """Qwen3-1.7B's linears at 1024 rows take the wgmma route: tiles of 128
    output columns by 128 rows of x, or by 64 rows for the k/v
    projections (N 1024: 64 tiles of 128 rows would leave half the SMs
    idle)."""
    from repro_torch.kernels.dequant_matmul import lora_plan
    p = lora_plan(1024, K, N, 64, 64, bf16=True, aligned=True,
                  n_sm=H100_SMS)
    assert p.route == "wgmma" and p.bn == 128
    assert p.bm == (64 if N == 1024 else 128)
    assert p.tiles == -(-1024 // p.bm) * -(-N // p.bn)
    assert p.grid == min(p.tiles, H100_SMS)     # persistent: one a SM
    assert p.tiles >= 128                       # 97% of the SMs or more
    assert p.xa_splits * p.xa_chunk >= K > (p.xa_splits - 1) * p.xa_chunk
    assert p.xa_chunk % 64 == 0
    assert p.xa_splits == 8             # 16 x 8 prologue blocks


@pytest.mark.parametrize("M,N,bm", [(1, 2048, 64), (63, 2048, 64),
                                    (64, 6144, 64), (65, 2048, 64),
                                    (200, 6144, 128),
                                    (1000, 2048, 128), (1000, 1024, 64),
                                    (4096, 1024, 128), (1024, 1040, 128)])
def test_lora_plan_wgmma_rows_a_tile(M, N, bm):
    """The wgmma route's tiles have 128 rows of x, or 64 where x has at
    most 64 rows or 64-row tiles fill clearly more SMs; the prologue's K
    split is whole 64-row stages over at most 8 blocks, for any rank."""
    from repro_torch.kernels.dequant_matmul import lora_plan
    for r in (0, 8, 128):
        p = lora_plan(M, 2048, N, r, 64, bf16=True, aligned=True,
                      n_sm=H100_SMS)
        assert (p.route, p.bm, p.bn) == ("wgmma", bm, 128)
        assert p.tiles == -(-M // bm) * -(-N // 128)
        assert p.grid == min(p.tiles, H100_SMS)
        assert p.xa_chunk % 64 == 0 and 1 <= p.xa_splits <= 8
        assert p.xa_splits * p.xa_chunk >= 2048


def _bf16_split(v):
    """v (f32) as hi = bf16(v) and lo = bf16(v - hi), both widened to f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _wgmma_route_emulated(x, packed, s, z, a, b, bits, g):
    """The wgmma route's arithmetic in plain PyTorch on the CPU: the zero
    split into zi = round(z) (clamped to the range where the codes stay
    exact) and zf = z - zi; each 64-row stage's sums x @ (codes - zi) of
    exact bf16 values in f32, folded with the stage's group's f32 scale;
    the rest, the sum over stages of -s * zf * sum(x), as bf16 hi/lo
    halves of both factors (the correction blocks); the LoRA term as
    [hi | lo] @ [B^T; B^T], hi = bf16(x @ A), lo = bf16(x @ A - hi); the
    output in bf16."""
    from repro_torch.core.quantizer import unpack_codes
    M, K = x.shape
    lo, hi = (-128.0, 128.0) if bits < 8 else (0.0, 255.0)
    codes = unpack_codes(packed, bits, K).float()
    xf = x.float()
    acc = torch.zeros((M, packed.shape[1]))
    for k0 in range(0, K, 64):
        sg, zg = s[k0 // g], z[k0 // g]
        zi = torch.round(zg).clamp(lo, hi)
        part = xf[:, k0:k0 + 64] @ (codes[k0:k0 + 64] - zi)
        acc += sg * part
        c_hi, c_lo = _bf16_split(-sg * (zg - zi))
        g_hi, g_lo = _bf16_split(xf[:, k0:k0 + 64].sum(-1, keepdim=True))
        acc += (g_hi * c_hi + g_lo * c_hi) + (g_hi * c_lo + g_lo * c_lo)
    if a.shape[1]:
        xa = xf @ a.float()
        xa_hi, xa_lo = _bf16_split(xa)
        acc += (xa_hi + xa_lo) @ b.float().T
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g,r", [(64, 0), (64, 8), (128, 64), (256, 128)])
def test_wgmma_route_fold_matches_jax(bits, g, r):
    """The sums the wgmma route computes (per-stage sums of exact codes less
    the zero's whole part, folded with the group's f32 scale; the zero's
    fraction against the prologue's per-stage sums of x as bf16 halves;
    LoRA as hi/lo) against the JAX package's fused kernel (interpret mode)
    at its bf16 tolerance, with zeros that are not whole numbers."""
    M, K, N = 20, 256, 48
    packed, s, z = _packed(K, N, bits, g)
    z = z + RNG.uniform(-0.5, 0.5, size=z.shape).astype(np.float32)
    x = RNG.normal(size=(M, K)).astype(np.float32)
    a = (RNG.normal(size=(K, r)) / K ** 0.5).astype(np.float32)
    b = (RNG.normal(size=(N, r)) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    yj = jops.dequant_matmul(xb, jnp.asarray(packed), jnp.asarray(s),
                             jnp.asarray(z), bits=bits, group_size=g,
                             lora_a=jnp.asarray(a, jnp.bfloat16) if r else None,
                             lora_b=jnp.asarray(b, jnp.bfloat16) if r else None)
    t = [torch.from_numpy(v) for v in (packed, s, z)]
    yt = _wgmma_route_emulated(torch.from_numpy(x).to(torch.bfloat16), *t,
                               torch.from_numpy(a).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16), bits, g)
    np.testing.assert_allclose(to_np(yt), to_np(yj), **TOL_BF16)


def test_wgmma_route_fold_exact_at_k14336():
    """At K = 14336 the route keeps the weight the reference's f32
    (c - z) * s: the emulated route, with zeros that are not whole numbers,
    stays within ``chip_smoke``'s ``lora_precision`` bound of the exact
    (f64) product, 2^-8 |exact| + 1e-3, where a bf16 weight would not."""
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    M, K, N, g = 4, 14336, 64, 64
    packed, s, z = _packed(K, N, 4, g)
    z = z + RNG.uniform(-0.5, 0.5, size=z.shape).astype(np.float32)
    x = torch.from_numpy(RNG.normal(size=(M, K)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    a = torch.from_numpy((RNG.normal(size=(K, 64)) / K ** 0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((RNG.normal(size=(N, 64)) * 0.1)
                         .astype(np.float32)).to(torch.bfloat16)
    t = [torch.from_numpy(v) for v in (packed, s, z)]
    y = _wgmma_route_emulated(xb, *t, a, b, 4, g).double()
    W = dequantize_int(unpack_codes(t[0], 4, K), t[1], t[2], g,
                       dtype=torch.float64)
    x64 = xb.double()
    exact = x64 @ W + (x64 @ a.double()) @ b.double().T
    assert ((y - exact).abs() <= 2.0 ** -8 * exact.abs() + 1e-3).all()
    wb = W.to(torch.bfloat16).double()      # the weight rounded to bf16
    rounded = (x64 @ wb + (x64 @ a.double()) @ b.double().T)
    assert ((rounded - exact).abs() > 2.0 ** -8 * exact.abs() + 1e-3).any()


@pytest.mark.parametrize("M,K,N,r,g,aligned", [
    (1000, 256, 130, 64, 32, True),    # N % 16 != 0
    (4, 384, 200, 8, 64, True),        # N % 16 != 0
    (1000, 96, 40, 8, 48, True),       # N % 16 != 0, group 48
    (1024, 2048, 2048, 12, 64, True),  # r % 8 != 0
    (1024, 2048, 2048, 64, 48, True),  # group neither divides nor tiles 64
    (1024, 2048, 2048, 64, 8, True),   # group 8: 8 groups a stage
    (1024, 2052, 2048, 64, 4, True),   # K % 8 != 0, group 4: CUDA cores
    (1024, 2048, 2048, 64, 64, False),  # a base not 16-byte aligned
])
def test_lora_plan_ragged_shapes_take_mma(M, K, N, r, g, aligned):
    from repro_torch.kernels.dequant_matmul import lora_plan
    p = lora_plan(M, K, N, r, g, bf16=True, aligned=aligned, n_sm=H100_SMS)
    route = "mma" if g % 8 == 0 else "fma"   # mma folds at k8 or k16 steps
    assert (p.route, p.bm, p.bn) == (route, 64, 128)
    assert p.grid == p.tiles == -(-M // 64) * -(-N // 128)
    f = lora_plan(M, K, N, r, g, bf16=False, aligned=aligned, n_sm=H100_SMS)
    assert f.route == "fma" and f.grid == p.grid


def test_lora_plan_grid_rows():
    """The 64-row grid of the mma and fma kernels caps M at 65535 * 64;
    the persistent wgmma grid does not."""
    from repro_torch.kernels.dequant_matmul import lora_plan
    big = 65535 * 64 + 1
    with pytest.raises(ValueError, match="too many"):
        lora_plan(big, 64, 130, 8, 64, bf16=True, aligned=True, n_sm=132)
    p = lora_plan(big, 64, 128, 8, 64, bf16=True, aligned=True, n_sm=132)
    assert p.route == "wgmma" and p.grid == 132


# the decode kernels' routes, plain functions of the shape.  dequant_matmul
# at decode (bf16, 4 rows, every Qwen3-1.7B linear): the tensor-core route,
# one launch, a portable cluster, about 5/8 of an H100's SMs (the split
# measured fastest there); what TMA cannot address, f32 and more than 8
# rows: the CUDA-core route with its K split over the grid
QWEN_LINEARS = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("K,N", QWEN_LINEARS)
def test_dqmm_plan_decode_shapes_take_mma(M, K, N):
    from repro_torch.kernels.dequant_matmul import dqmm_plan
    p = dqmm_plan(M, K, N, 64, bf16=True, aligned=True, cpt=4,
                  n_sm=H100_SMS)
    stages = -(-K // 256)
    assert p.route == "mma" and p.launches == 1
    assert 1 <= p.splits <= 8 and p.bm == 0
    assert p.splits * p.per_split >= stages > (p.splits - 1) * p.per_split
    assert p.blocks == p.splits * -(-N // 128)
    assert 0.45 * H100_SMS <= p.blocks <= 0.75 * H100_SMS


# the split the plan picks at each linear: the power of two nearest 5/8 of
# the SMs, the fastest of 1, 2, 4 and 8 at each on an H100 (chip_smoke.py's
# dequant_splits line); a requested split is taken as far as K allows
@pytest.mark.parametrize("K,N,splits", [(2048, 1024, 8), (2048, 2048, 4),
                                        (2048, 6144, 2), (6144, 2048, 4)])
def test_dqmm_plan_split_at_qwen_linears(K, N, splits):
    from repro_torch.kernels.dequant_matmul import dqmm_plan
    kw = dict(bf16=True, aligned=True, cpt=4, n_sm=H100_SMS)
    assert dqmm_plan(4, K, N, 64, **kw).splits == splits
    for want in (1, 2, 4, 8):
        p = dqmm_plan(4, K, N, 64, splits=want, **kw)
        assert p.route == "mma" and p.splits == want
        assert p.splits * p.per_split >= K // 256
    assert dqmm_plan(4, 256, N, 64, splits=8, **kw).splits == 1


def test_plan_constants_come_from_the_sources():
    """The plan functions read the kernels' tile sizes and limits from the
    CUDA sources, where the entry points check them again."""
    from repro_torch.kernels import build
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import flash_attention as fa
    c = build.constants("dequant_matmul.cu")
    assert (dq._UNIT, dq._MMA_BN, dq._MMA_BK, dq._MMA_MAX_M,
            dq._MMA_MAX_SPLITS) == (128, 128, 256, 8, 8)
    assert c["UNIT"] == c["NWARP"] * c["KS"]
    assert (fa._ROWS, fa._MAX_SPLITS, fa._SPLIT_KEYS, fa._STAGES,
            fa._SMEM_MAX, fa._MAX_PARTS) == (16, 8, 32, 3, 232448, 16)
    f = build.constants("flash_attention.cu")
    assert (fa._CONSUMERS, fa._MAX_STAGES) == (f["CONSUMERS"],
                                               f["MAX_STAGES"]) == (4, 8)
    assert f["BULK_THREADS"] == 32 * (fa._CONSUMERS + 1)
    assert f["BOX_BYTES"] == 32 * f["BOX_DIMS"] * 2 == 4096


@pytest.mark.parametrize("M,K,N,g,bf16,aligned", [
    (4, 2048, 200, 64, True, True),     # N % 16 != 0
    (4, 2052, 2048, 4, True, True),     # K % 8 != 0, group 4
    (4, 2048, 2048, 16, True, True),    # group 16 < 32
    (4, 2304, 2048, 384, True, True),   # group 384 does not tile 256 rows
    (4, 2048, 2048, 64, True, False),   # a base not 16-byte aligned
    (9, 2048, 2048, 64, True, True),    # more than 8 rows
    (4, 2048, 2048, 64, False, True),   # f32 x stays on CUDA cores
])
def test_dqmm_plan_other_shapes_take_fma(M, K, N, g, bf16, aligned):
    from repro_torch.kernels.dequant_matmul import dqmm_plan
    p = dqmm_plan(M, K, N, g, bf16=bf16, aligned=aligned, cpt=4,
                  n_sm=H100_SMS)
    assert p.route == "fma" and p.bm in (1, 2, 4, 8)
    units = -(-K // 128)
    assert p.splits * p.per_split >= units > (p.splits - 1) * p.per_split
    assert p.launches == (2 if p.splits > 1 else 1)


# flash_attention at decode (B 4, Hq 16, Hkv 8, d 128, one query row): the
# keys of each (batch, KV head) split over a cluster; chunks of 32 keys or
# more; bf16 on the tensor cores from a TMA ring (the bulk route), f32 on
# the CUDA cores
@pytest.mark.parametrize("Sk", [1, 127, 128, 4096])
@pytest.mark.parametrize("elem", [2, 4])
def test_flash_plan_decode_splits_keys_over_a_cluster(Sk, elem):
    from repro_torch.kernels.flash_attention import flash_plan
    p = flash_plan(4, 16, 8, 1, Sk, 128, elem=elem, vec=True,
                   n_sm=H100_SMS)
    assert p.route == ("bulk" if elem == 2 else "split") and p.launches == 1
    assert 1 <= p.splits <= 8 and p.chunk % 32 == 0
    assert p.splits * p.chunk >= Sk > (p.splits - 1) * p.chunk
    assert p.blocks == 32 * p.splits
    if elem == 4:
        # a split per 32-key chunk up to 4 blocks a (batch, KV head), 128
        # of 132 SMs; 2 key groups at 4096 keys (4 in bf16 is too much
        # shared memory for f32)
        assert p.splits * p.kw <= 16
        assert p.splits == min(4, -(-Sk // 32))
        assert p.kw == (1 if Sk <= 128 else 2) and p.stages == 0
    else:
        # a block of at least two tiles up to 4 blocks a (batch, KV head);
        # the ring as deep as the block's tiles, up to 8
        assert p.splits == min(4, -(-Sk // 64)) and p.kw == 0
        assert p.stages == min(8, p.chunk // 32)


# the bulk route at the sequence-sharded decode's shards, one rank each:
# decode_32k's production shard (Qwen3-1.7B on one rank of 16 x 16: 8
# rows, 16 q heads, 8 KV heads, 2048 keys, d 128), seq_kv's (Qwen3-30B-A3B
# on model 8: 4 rows, 32 q heads, 4 KV heads, 8 keys), a ragged shard
# (1000 keys) and d 64: (B, Hq, Hkv, Sk, d), then route, splits, chunk,
# stages, blocks
@pytest.mark.parametrize("shape,want", [
    ((8, 16, 8, 2048, 128), (2, 1024, 8, 128)),
    ((4, 32, 4, 8, 128), (1, 32, 1, 16)),
    ((8, 16, 8, 1000, 128), (2, 512, 8, 128)),
    ((8, 16, 8, 2048, 64), (2, 1024, 8, 128)),
])
def test_flash_plan_bulk_route_at_the_shards(shape, want):
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sk, d = shape
    p = fa.flash_plan(B, Hq, Hkv, 1, Sk, d, elem=2, vec=True,
                      n_sm=H100_SMS)
    assert p.route == "bulk" and p.launches == 1
    assert (p.splits, p.chunk, p.stages, p.blocks) == want
    # the cluster within the portable 8, the block within shared memory
    assert p.splits <= fa._MAX_SPLITS == 8
    hpb = min(Hq // Hkv, 16)
    assert fa.bulk_smem(d, hpb, p.stages) <= fa._SMEM_MAX
    # one block an SM at most: 128 of 132
    assert p.blocks <= H100_SMS
    # a ring a block goes round holds whole tiles a consumer warp
    assert p.stages % fa._CONSUMERS == 0 or p.stages >= p.chunk // 32
    # every tile, the ragged last one too, expects whole boxes: 32 keys of
    # K and of V (rows past Sk arrive as zeros, rows past the range are
    # zeroed); the last tile starts on a whole tile of the last block
    assert fa.tile_tx_bytes(d) == 2 * 32 * d * 2 == 2 * fa._C["BOX_BYTES"] \
        * (d // fa._C["BOX_DIMS"])
    start = (Sk - 1) // 32 * 32
    assert Sk - start == {2048: 32, 8: 8, 1000: 8}[Sk]
    assert start >= (p.splits - 1) * p.chunk and p.chunk % 32 == 0


def test_flash_plan_bulk_ring_fits_the_blocks_an_sm_holds():
    """More (batch, KV head) blocks than SMs: the ring shrinks so that the
    blocks an SM must hold fit its shared memory, and stays a multiple of
    the consumer warps when a block goes round it; ``splits`` and
    ``stages`` override the plan (chip_smoke.py's sweeps)."""
    from repro_torch.kernels import flash_attention as fa
    p = fa.flash_plan(32, 16, 8, 1, 4096, 128, elem=2, vec=True,
                      n_sm=H100_SMS)
    assert (p.route, p.splits, p.chunk, p.blocks) == ("bulk", 1, 4096, 256)
    assert p.stages == 4 and 2 * (fa.bulk_smem(128, 2, 4) + 1024) <= 233472
    q = fa.flash_plan(8, 16, 8, 1, 2048, 128, elem=2, vec=True,
                      n_sm=H100_SMS, splits=8, stages=6)
    assert (q.splits, q.chunk, q.stages) == (8, 256, 4)
    assert fa.flash_plan(8, 16, 8, 1, 2048, 128, elem=2, vec=True,
                         n_sm=H100_SMS, splits=1).stages == 8


@pytest.mark.parametrize("shape,vec", [
    ((1, 16, 8, 256, 256, 128), True),   # prefill: many query rows
    ((4, 16, 8, 1, 128, 128), False),    # a view 16-byte loads cannot read
    ((2, 4, 2, 1, 64, 196), True),       # d not a multiple of d / 32 lanes
])
def test_flash_plan_other_shapes_take_tiled(shape, vec):
    from repro_torch.kernels.flash_attention import flash_plan
    p = flash_plan(*shape, elem=4, vec=vec, n_sm=H100_SMS)
    assert p.route == "tiled" and p.launches == 1 and p.splits == 0


# gram: bf16 x that TMA can address takes the tensor cores (128 x 128
# tiles of the upper triangle, persistent blocks, one an SM as far as
# there are tiles: 136 at D = 2048, 1176 at 6144, whatever T is); f32 and
# what TMA cannot address take the CUDA-core route over 64 x 64 tiles
@pytest.mark.parametrize("T", [1024, 128])
@pytest.mark.parametrize("D", [2048, 6144])
def test_gram_plan_qwen_shapes_take_wgmma(T, D):
    from repro_torch.kernels.gram import gram_plan
    p = gram_plan(T, D, bf16=True, aligned=True, n_sm=H100_SMS)
    nb = D // 128
    assert (p.route, p.tile) == ("wgmma", 128)
    assert p.tiles == nb * (nb + 1) // 2 == {2048: 136, 6144: 1176}[D]
    assert p.grid == H100_SMS
    assert gram_plan(T, D, bf16=True, aligned=True, n_sm=H100_SMS,
                     grid=33).grid == 33


@pytest.mark.parametrize("D,tiles", [(8, 1), (136, 3), (1032, 45)])
def test_gram_plan_grid_is_at_most_a_block_a_tile(D, tiles):
    from repro_torch.kernels.gram import gram_plan
    for grid in (None, 500):
        p = gram_plan(1, D, bf16=True, aligned=True, n_sm=H100_SMS,
                      grid=grid)
        assert p.route == "wgmma" and p.tiles == p.grid == tiles


@pytest.mark.parametrize("T,D,bf16,aligned", [
    (1024, 2048, False, True),   # f32: its rtol 1e-4 rules out plain TF32
    (1024, 6144, False, True),
    (37, 50, True, True),        # D % 8 != 0: no 16-byte row stride
    (300, 130, True, True),
    (1000, 2047, True, True),
    (1024, 2048, True, False),   # a base not 16-byte aligned
])
def test_gram_plan_f32_and_unaddressable_take_fma(T, D, bf16, aligned):
    from repro_torch.kernels.gram import gram_plan
    p = gram_plan(T, D, bf16=bf16, aligned=aligned, n_sm=H100_SMS)
    nb = -(-D // 64)
    assert (p.route, p.tile) == ("fma", 64)
    assert p.grid == p.tiles == nb * nb


def test_gram_plan_constants_come_from_the_source():
    """gram_plan reads both routes' tile edges from gram.cu, where the
    entry point checks the plan again; the wgmma route's ring and staging
    fit a block's shared memory."""
    from repro_torch.kernels import build
    from repro_torch.kernels import gram
    c = build.constants("gram.cu")
    assert (gram._TILE, gram._WG_TILE) == (c["TILE"], c["WG_TILE"]) \
        == (64, 128)
    assert c["STAGE_BYTES"] == 2 * 128 * c["WG_BK"] * 2
    assert c["WG_SMEM"] == (1024 + c["WG_STAGES"] * c["STAGE_BYTES"]
                            + 128 * 128 * 4 + 128)
    assert c["WG_SMEM"] <= c["WG_SMEM_LIMIT"] == 232448


def test_fault_check_plants_one_fault():
    """chip_fault_check.py's planted fault (the attention combine leaves
    out the last rank's partial) still finds its one line in the kernel."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.KERNEL).read_text()
    fault = fc.plant_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(changed) == 1 and fc.FAULT in changed[0][1]
    with pytest.raises(ValueError):
        fc.plant_fault(fault)
    # the line is the cluster combine's, which the bulk route (the bf16
    # decode's, partial mode included) ends in, and the split route too
    combine = sound[sound.index("void combine_partials("):]
    assert fc.SOUND in combine[:combine.index("\n}\n")]
    bulk = sound[sound.index("flash_bulk_kernel("):]
    assert "combine_partials<bf16>(" in bulk[:bulk.index("\n}\n")]
    # the decode_32k partial case counts as caught only when it fails
    row = {"kernel": "flash_partial", "passes": False}
    assert fc.partial_caught([row, {"kernel": "gram", "passes": True}])
    assert not fc.partial_caught([{**row, "passes": True}])
    assert not fc.partial_caught([{"kernel": "gram", "passes": False}])


def test_fault_check_plants_the_gram_fault():
    """chip_fault_check.py's planted gram fault (the last token stage of
    each tile loaded from the stage before it) finds its one line in the
    kernel, and the check names it among what it must catch."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.GRAM_KERNEL).read_text()
    fault = fc.plant_gram_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(changed) == 1 and fc.GRAM_FAULT in changed[0][1]
    assert "ks * WG_BK" in changed[0][0]
    with pytest.raises(ValueError):
        fc.plant_gram_fault(fault)


def test_fault_check_plants_the_dequant_fault():
    """chip_fault_check.py's planted decode fault (the zeros of half the
    columns one off in the first K stage) finds its one line in
    ``dequant_matmul.cu``, and the limit its logits cases are held to
    grows with the calls a decode step makes and the logits' scale."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.DQ_KERNEL).read_text()
    fault = fc.plant_dequant_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(changed) == 1 and fc.DQ_FAULT in changed[0][1]
    assert fc.DQ_SOUND in changed[0][0]
    with pytest.raises(ValueError):
        fc.plant_dequant_fault(fault)
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    assert cs.logits_limit(5.0, 16) == pytest.approx(
        cs.LOGIT_ATOL + cs.LOGIT_RTOL * 4 * 5.0)
    assert cs.logits_limit(5.0, 64) > cs.logits_limit(5.0, 16) > \
        cs.logits_limit(1.0, 16)


def test_fault_check_plants_the_lora_fault():
    """chip_fault_check.py's planted fused-kernel fault (each group's scale
    rounded to bf16 in the wgmma route's fold) finds its one line in
    ``dequant_matmul_lora.cu``, and the precision cases it runs are
    ``chip_smoke``'s, whose exact-product bound is one bf16 rounding of
    the output with room."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.LORA_KERNEL).read_text()
    fault = fc.plant_lora_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(changed) == 1 and fc.LORA_FAULT in changed[0][1]
    assert fc.LORA_SOUND in changed[0][0]
    with pytest.raises(ValueError):
        fc.plant_lora_fault(fault)
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    assert cs.LORA_EXACT_RTOL == 2.0 ** -8 and cs.LORA_EXACT_ATOL == 1e-3
    assert [K for _, K, _ in cs.LORA_PRECISION] == [14336, 14336]
    assert cs.LORA_PRECISION_ANY_ZERO[1] == 14336


@pytest.mark.parametrize("variant", [0, 1, 2, 4, 8, 15])
def test_lora_probe_edits_apply(variant):
    """chip_lora_probe.py's probe builds are text edits of a copy of
    ``dequant_matmul_lora.cu``: each finds its one place in the source as
    it stands, variant 0 is the source itself, and the source the port
    builds holds none of the probe's code."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_lora_probe", root / "chip_lora_probe.py")
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    text = pr.SRC.read_text()
    assert "dq_trace" not in text and "trace(" not in text
    probe = pr.probe_source(text, variant)
    assert (probe == text) == (variant == 0)
    assert ("dq_probe_read" in probe) == bool(variant & 8)
    assert probe.count("trace(") == (7 if variant & 8 else 0)   # 7 events
    assert ("if (false)" in probe) == bool(variant & 4)


def test_fault_check_plants_the_dist_fault():
    """chip_fault_check.py's planted distributed fault (the Gram trick's
    all-reduce left out of ``svd_lowrank_topr``, so each rank factorizes
    its local Gram only) changes exactly one line of ``core/loftq.py``,
    the line with the engine's one collective, and the cases it runs are
    ``chip_smoke``'s distributed checks of CLoQ and LoftQ at the
    reference's ``A @ B^T`` tolerance."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", root / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sound = (root / fc.DIST_SOURCE).read_text()
    fault = fc.plant_dist_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert len(changed) == 1 and changed[0] == (fc.DIST_SOUND,
                                                fc.DIST_FAULT)
    assert "all_reduce" not in fault.split("def svd_lowrank_topr")[1] \
        .split("def ")[0].replace("all-reduced", "")
    with pytest.raises(ValueError):
        fc.plant_dist_fault(fault)
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    assert cs.DIST_METHODS == ("cloq", "loftq")
    assert cs.DIST_LORA_REL == 5e-3 and cs.DIST_RANKS == 2