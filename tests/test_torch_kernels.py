"""Port parity for the kernel modules.

On the CPU: the plain versions in ``repro_torch.kernels.ref`` against the
JAX package's kernels run as ``tests/test_kernels.py`` runs them (Pallas
in interpret mode), with that file's tolerances — dequant-matmul 2e-4 in
f32 and 2e-2 in bf16 (``test_kernels.py:12-14``), flash attention 1e-4 in
f32 and 5e-2 in bf16 (``test_kernels.py:85-98``) — and the ``ops``
wrappers' CPU dispatch.  The CUDA kernels themselves are held against the
plain versions in ``tests/test_torch_cuda.py``, on the card.
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
    assert ops.launch_counts() == {"dequant_matmul": 0, "flash_attention": 0}


def test_ops_rejects_other_devices():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.dequant_matmul(x, x, x, x, bits=4, group_size=16)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(x, x, x)
