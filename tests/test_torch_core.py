"""Port parity: MagR, OPTQ and CLoQ (``repro_torch.core``) against the JAX
package's single-device functions on the same (W, H).

Tolerances and their sources:
  * MagR: rtol 1e-4 / atol 1e-5 (f32; both run the same unrolled Newton
    projection and power iteration, in a different summation order);
  * OPTQ: >= 99.9% equal codes and Qd within atol 2e-4
    (``tests/test_distributed.py:89-90``), grids bit-exact;
  * CLoQ: ``A @ B^T`` within atol 1e-4 (``tests/test_cloq.py:58-61``);
    factors themselves carry arbitrary signs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cloq as jc
from repro.core import magr as jm
from repro.core import optq as jo
from repro.core.batched import magr_alpha as j_magr_alpha
from repro.core.quantizer import QuantConfig as JQC
from repro_torch.core import cloq as tc
from repro_torch.core import magr as tm
from repro_torch.core import optq as to
from repro_torch.core.quantizer import QuantConfig as TQC
from tests.torch_parity import to_np


def _case(seed, m=64, n=48, t=256):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, n)).astype(np.float32)
    X = rng.normal(size=(t, m)).astype(np.float32)
    H = (X.T @ X).astype(np.float32)
    return W, H


def test_project_l1_ball_and_prox():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(32, 16)).astype(np.float32)
    for r in (0.5, 3.0, 100.0):
        np.testing.assert_allclose(
            to_np(tm.project_l1_ball(torch.from_numpy(v), r)),
            to_np(jm.project_l1_ball(jnp.asarray(v), r)), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(
            to_np(tm.prox_linf(torch.from_numpy(v), r)),
            to_np(jm.prox_linf(jnp.asarray(v), r)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_magr_preprocess(seed):
    W, H = _case(seed)
    m = W.shape[0]
    aj = j_magr_alpha(jnp.asarray(H), m)
    at = tm.magr_alpha(torch.from_numpy(H), m)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    Wj = jm.magr_preprocess(jnp.asarray(W), jnp.asarray(H), alpha=aj)
    Wt = tm.magr_preprocess(torch.from_numpy(W), torch.from_numpy(H),
                            alpha=at)
    np.testing.assert_allclose(to_np(Wt), to_np(Wj), rtol=1e-4, atol=1e-5)


def test_dampen_and_inverse_cholesky():
    _, H = _case(2)
    Hd_j = jo.dampen(jnp.asarray(H), 0.01)
    Hd_t = to.dampen(torch.from_numpy(H), 0.01)
    np.testing.assert_allclose(to_np(Hd_t), to_np(Hd_j), rtol=1e-6)
    np.testing.assert_allclose(to_np(to.inv_cholesky_upper(Hd_t)),
                               to_np(jo.inv_cholesky_upper(Hd_j)),
                               rtol=1e-3, atol=1e-5)
    for m, b in ((256, 128), (96, 128), (100, 64), (7, 4)):
        assert to.pick_block(m, b) == jo.pick_block(m, b)


@pytest.mark.parametrize("bits,group,act_order",
                         [(4, 16, False), (2, 16, False), (4, 32, True),
                          (3, 16, False)])
def test_optq_quantize(bits, group, act_order):
    W, H = _case(3 + bits, m=128, n=64, t=512)
    jcfg = JQC(bits=bits, group_size=group, act_order=act_order,
               block_size=32)
    tcfg = TQC(bits=bits, group_size=group, act_order=act_order,
               block_size=32)
    Qj, Cj, sj, zj = jo.optq_quantize(jnp.asarray(W), jnp.asarray(H), jcfg)
    Qt, Ct, st, zt = to.optq_quantize(torch.from_numpy(W),
                                      torch.from_numpy(H), tcfg)
    np.testing.assert_array_equal(to_np(st), to_np(sj))
    np.testing.assert_array_equal(to_np(zt), to_np(zj))
    assert Ct.dtype == torch.uint8
    assert (to_np(Ct) == to_np(Cj)).mean() >= 0.999
    np.testing.assert_allclose(to_np(Qt), to_np(Qj), atol=2e-4)
    Dj, Dt = jnp.asarray(W) - Qj, torch.from_numpy(W) - Qt
    assert abs(to.gram_error(torch.from_numpy(H), Dt)
               - jo.gram_error(jnp.asarray(H), Dj)) <= \
        1e-4 * jo.gram_error(jnp.asarray(H), Dj)


@pytest.mark.parametrize("split", ["paper", "bsigma", "sqrt"])
def test_cloq_init_product(split):
    W, H = _case(7)
    rng = np.random.default_rng(8)
    dW = (0.05 * rng.normal(size=W.shape)).astype(np.float32)
    Hj = jc.regularize_gram(jnp.asarray(H))
    Ht = tc.regularize_gram(torch.from_numpy(H))
    np.testing.assert_allclose(to_np(Ht), to_np(Hj), rtol=1e-6)
    Aj, Bj = jc.cloq_init(Hj, jnp.asarray(dW), 8, split)
    At, Bt = tc.cloq_init(Ht, torch.from_numpy(dW), 8, split)
    assert At.shape == (64, 8) and Bt.shape == (48, 8)
    np.testing.assert_allclose(to_np(At @ Bt.T), to_np(Aj @ Bj.T), atol=1e-4)
    objj = jc.lowrank_objective(Hj, jnp.asarray(dW), Aj, Bj)
    objt = tc.lowrank_objective(Ht, torch.from_numpy(dW), At, Bt)
    assert abs(objt - objj) <= 1e-4 * objj
    Q = np.zeros_like(W)
    fj = jc.discrepancy_norms(Hj, jnp.asarray(Q), Aj, Bj, jnp.asarray(W))
    ft = tc.discrepancy_norms(Ht, torch.from_numpy(Q), At, Bt,
                              torch.from_numpy(W))
    np.testing.assert_allclose(ft, fj, rtol=1e-4)


def test_gram_root_and_bad_split():
    _, H = _case(9)
    Rj, Rij = jc.gram_root(jc.regularize_gram(jnp.asarray(H)))
    Rt, Rit = tc.gram_root(tc.regularize_gram(torch.from_numpy(H)))
    # eigenvector signs are arbitrary: compare R^T R and R Rinv
    np.testing.assert_allclose(to_np(Rt.T @ Rt), to_np(Rj.T @ Rj),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(to_np(Rt @ Rit), np.eye(H.shape[0]),
                               atol=1e-3)
    with pytest.raises(ValueError):
        tc.split_factors(Rt, torch.ones(4), Rt, "nope")
