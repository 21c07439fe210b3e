"""Port parity: ``repro_torch.core.quantizer`` against ``repro.core.quantizer``.

Tolerance: none.  Codes, scales, zeros, packed bytes and dequantized
weights must be bit-exact (the port's rule for integer state, ROADMAP.md)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro_torch.core import quantizer as tq
from tests.torch_parity import to_np


def _w(seed, m=128, n=48):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("group", [16, 64, None])
def test_quantize_pack_bit_exact(bits, group):
    W = _w(bits * 7 + (group or 0))
    cj, sj, zj = jq.quantize_int(jnp.asarray(W), bits, group)
    ct, st, zt = tq.quantize_int(torch.from_numpy(W), bits, group)
    assert ct.dtype == torch.uint8
    np.testing.assert_array_equal(to_np(cj), to_np(ct))
    np.testing.assert_array_equal(to_np(sj), to_np(st))
    np.testing.assert_array_equal(to_np(zj), to_np(zt))
    pj, pt = jq.pack_codes(cj, bits), tq.pack_codes(ct, bits)
    np.testing.assert_array_equal(to_np(pj), to_np(pt))
    np.testing.assert_array_equal(to_np(tq.unpack_codes(pt, bits, W.shape[0])),
                                  to_np(ct))
    np.testing.assert_array_equal(
        to_np(jq.dequantize_int(cj, sj, zj, group)),
        to_np(tq.dequantize_int(ct, st, zt, group)))


def test_stable_round_ties():
    x = (np.arange(-40, 40, dtype=np.float32) + 0.5)
    x = np.concatenate([x, np.nextafter(x, np.inf), np.nextafter(x, -np.inf)])
    np.testing.assert_array_equal(to_np(jq.stable_round(jnp.asarray(x))),
                                  to_np(tq.stable_round(torch.from_numpy(x))))


@pytest.mark.parametrize("group", [16, 64])
def test_nf4_bit_exact(group):
    W = _w(3)
    cj, aj = jq.quantize_nf4(jnp.asarray(W), group)
    ct, at = tq.quantize_nf4(torch.from_numpy(W), group)
    np.testing.assert_array_equal(to_np(cj), to_np(ct))
    np.testing.assert_array_equal(to_np(aj), to_np(at))
    np.testing.assert_array_equal(to_np(jq.dequantize_nf4(cj, aj, group)),
                                  to_np(tq.dequantize_nf4(ct, at, group)))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_state_size_and_config(bits):
    for m, n, g in ((2048, 6144, 64), (64, 48, None), (96, 32, 32)):
        jc = jq.QuantConfig(bits=bits, group_size=g)
        tc = tq.QuantConfig(bits=bits, group_size=g)
        assert tq.quant_state_size_bytes(m, n, tc) == \
            jq.quant_state_size_bytes(m, n, jc)
        assert tc.codes_per_byte() == jc.codes_per_byte()
        assert tc.n_levels == jc.n_levels


def test_group_must_divide_rows():
    with pytest.raises(ValueError):
        tq.quantize_int(torch.zeros(48, 8), 4, 32)
