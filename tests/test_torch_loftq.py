"""Port parity: the baseline methods (``repro_torch.core.loftq``,
``quantizer.rtn`` and the gptq branch of ``pipeline._quantize_one``)
against the JAX package on the same numpy inputs.

Tolerances and their sources:
  * ``rtn`` and QLoRA's NF4 base (codes, absmax, dequantized weight):
    bit-exact (the same elementwise ops on the same f32 values);
  * LoftQ after 1 and 5 AltMin rounds: codes equal up to the reference's
    batched-vs-sequential flip budget 0.005 (``tests/test_batched.py``),
    grids and ``A @ B^T`` within 1e-3 relative Frobenius (factors carry
    arbitrary signs; an SVD in another library rounds differently, and a
    code near a rounding boundary may flip in a later round);
  * GPTQ-LoRA: the OPTQ base bit-exact on these inputs (codes, scales,
    zeros), ``B == 0``, and ``A ~ N(0, 1/m)`` held by its statistics
    (``A`` comes from a ``torch.Generator``, not ``jax.random``): mean
    within 4 standard errors of 0 and standard deviation within 5% of
    ``1/sqrt(m)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import loftq as jl
from repro.core import pipeline as jp
from repro.core import quantizer as jq
from repro.models.modules import QSpec as JQSpec
from repro_torch.core import loftq as tl
from repro_torch.core import pipeline as tp
from repro_torch.core import quantizer as tq
from repro_torch.core.batched import task_key
from repro_torch.models.modules import QSpec as TQSpec
from tests.torch_parity import to_np

FLIP_BUDGET = 0.005
REL = 1e-3


def _w(seed, m=64, n=48):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("bits,group,fmt", [(4, 16, "int"), (2, 32, "int"),
                                            (8, None, "int"),
                                            (4, 16, "nf4")])
def test_rtn_bit_exact(bits, group, fmt):
    W = _w(bits)
    got = tq.rtn(torch.from_numpy(W),
                 tq.QuantConfig(bits=bits, group_size=group, fmt=fmt))
    want = jq.rtn(jnp.asarray(W),
                  jq.QuantConfig(bits=bits, group_size=group, fmt=fmt))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("group", [16, 64])
def test_qlora_init_codes_and_absmax_bit_exact(group):
    W = _w(11, m=128, n=40)
    jcfg = jq.QuantConfig(bits=4, group_size=group)
    tcfg = tq.QuantConfig(bits=4, group_size=group)
    Qj, _, Bj, (cj, aj) = jl.qlora_init(jnp.asarray(W), jcfg, 8,
                                        jax.random.PRNGKey(0))
    A = torch.randn(128, 8)
    Qt, At, Bt, (ct, at) = tl.qlora_init(torch.from_numpy(W), tcfg, A)
    np.testing.assert_array_equal(to_np(ct), np.asarray(cj))
    np.testing.assert_array_equal(to_np(at), np.asarray(aj))
    np.testing.assert_array_equal(to_np(Qt), np.asarray(Qj))
    assert At is A and Bt.shape == Bj.shape and not Bt.any()


@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("bits,group", [(4, 16), (2, 16)])
def test_loftq_init_matches_jax(iters, bits, group):
    W = _w(20 + iters + bits, m=64, n=96)
    Qj, Aj, Bj, (cj, sj, zj) = jl.loftq_init(
        jnp.asarray(W), jq.QuantConfig(bits=bits, group_size=group), 8,
        iters=iters)
    Qt, At, Bt, (ct, st, zt) = tl.loftq_init(
        torch.from_numpy(W), tq.QuantConfig(bits=bits, group_size=group), 8,
        iters=iters)
    assert ct.dtype == torch.uint8 and tuple(At.shape) == (64, 8)
    assert float((to_np(ct) != np.asarray(cj)).mean()) <= FLIP_BUDGET
    assert _rel(to_np(st), sj) <= REL and _rel(to_np(zt), zj) <= REL
    assert _rel(to_np(At @ Bt.T), np.asarray(Aj @ Bj.T)) <= REL
    assert _rel(to_np(Qt), Qj) <= REL


def test_loftq_init_takes_a_stack():
    """A bucket's stack gives each slice what the 2-D call gives it."""
    Ws = torch.from_numpy(np.stack([_w(s, m=64, n=32) for s in range(3)]))
    cfg = tq.QuantConfig(bits=4, group_size=16)
    Qs, As, Bs, (cs, ss, zs) = tl.loftq_init(Ws, cfg, 4, iters=2)
    for i in range(3):
        Q, A, B, (c, s, z) = tl.loftq_init(Ws[i], cfg, 4, iters=2)
        assert float((cs[i] != c).float().mean()) <= FLIP_BUDGET
        assert _rel(to_np(As[i] @ Bs[i].T), to_np(A @ B.T)) <= REL
        assert _rel(to_np(ss[i]), to_np(s)) <= REL


def test_gptq_base_bit_exact_and_random_a_statistics():
    m, n, r = 128, 64, 32
    rng = np.random.default_rng(4)
    W = rng.normal(size=(m, n)).astype(np.float32)
    X = rng.normal(size=(512, m)).astype(np.float32)
    H = X.T @ X
    qs = dict(bits=4, group_size=16, rank=r, method="gptq")
    want = jp._quantize_one(jnp.asarray(W), jnp.asarray(H), JQSpec(**qs),
                            "gptq", jax.random.PRNGKey(0))
    got = tp._quantize_one(torch.from_numpy(W), torch.from_numpy(H),
                           TQSpec(**qs), "gptq", task_key(0, 0))
    for k in ("qcodes", "scales", "zeros"):
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert not got["lora_b"].any() and tuple(got["lora_b"].shape) == (n, r)
    A = to_np(got["lora_a"]).astype(np.float64)
    assert A.shape == (m, r)
    sd = 1 / np.sqrt(m)
    assert abs(A.mean()) <= 4 * sd / np.sqrt(A.size)
    assert abs(A.std() / sd - 1) <= 0.05
    # the reference's own draw has the same law
    Aj = np.asarray(want["lora_a"], np.float64)
    assert abs(Aj.std() / sd - 1) <= 0.05


@pytest.mark.parametrize("method", ["gptq", "qlora", "rtn"])
def test_random_a_depends_on_seed_and_site_only(method):
    """Each site's A comes from its own generator, seeded by (seed, site
    index): the same draw for the same key, another for another key."""
    W = torch.from_numpy(_w(3))
    H = W.new_tensor(np.eye(64, dtype=np.float32))
    q = TQSpec(bits=4, group_size=16, rank=4, method=method)
    a = tp._quantize_one(W, H, q, method, task_key(0, 5))["lora_a"]
    b = tp._quantize_one(W, H, q, method, task_key(0, 5))["lora_a"]
    c = tp._quantize_one(W, H, q, method, task_key(0, 6))["lora_a"]
    d = tp._quantize_one(W, H, q, method, task_key(1, 5))["lora_a"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d) and tuple(a.shape) == (64, 4)
