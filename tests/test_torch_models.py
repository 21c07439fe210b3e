"""Port parity: modules, attention, MLP and the dense transformer.

The same numpy params and inputs go through ``repro.models`` and
``repro_torch.models`` (params from JAX ``init_params`` exported to numpy
and carried over with ``repro_torch.convert.params_from_jax``).  f32
throughout; tolerance atol/rtol 1e-4 for one layer's output and for the
logits (f32 matmuls summed in another order), as the port's rule states
for f32 paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro.models import attention as ja
from repro.models import mlp as jmlp
from repro.models import modules as jmod
from repro.models import transformer as jt
from repro_torch.models import attention as ta
from repro_torch.models import mlp as tmlp
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as tt
from tests.torch_parity import configs, port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
RNG = np.random.default_rng(0)


def _np(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jnp tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _quant_linear(m, n, bits, g, kind):
    W = _np(m, n)
    if kind == "nf4":
        codes, absmax = jq.quantize_nf4(jnp.asarray(W), g)
        return {"qcodes": np.array(jq.pack_codes(codes, 4)),
                "absmax": np.array(absmax)}
    codes, s, z = jq.quantize_int(jnp.asarray(W), bits, g)
    return {"qcodes": np.array(jq.pack_codes(codes, bits)),
            "scales": np.array(s), "zeros": np.array(z)}


LINEAR_CASES = {
    "dense": lambda: {"w": _np(64, 48, scale=0.1)},
    "dense_bias": lambda: {"w": _np(64, 48, scale=0.1), "b": _np(48)},
    "int4": lambda: _quant_linear(64, 48, 4, 16, "int"),
    "int2_lora": lambda: {**_quant_linear(64, 48, 2, 16, "int"),
                          "lora_a": _np(64, 8, scale=0.1),
                          "lora_b": _np(48, 8, scale=0.1)},
    "int8_bias": lambda: {**_quant_linear(64, 48, 8, 32, "int"),
                          "b": _np(48)},
    "int3_raw": lambda: _quant_linear(64, 48, 3, 16, "int"),
    "nf4": lambda: _quant_linear(64, 48, 4, 16, "nf4"),
    "lora_3d": lambda: {"w": _np(64, 48, scale=0.1),
                        "lora_a": _np(2, 64, 4, scale=0.1),
                        "lora_b": _np(2, 48, 4, scale=0.1)},
}


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_linear_apply_branches(case, kernel):
    pj, pt = _both(LINEAR_CASES[case]())
    x = _np(2, 5, 64)
    qj = jmod.QSpec(use_kernel=kernel)
    qt = tmod.QSpec(use_kernel=kernel)
    yj = jmod.linear_apply(pj, jnp.asarray(x), qj)
    yt = tmod.linear_apply(pt, torch.from_numpy(x), qt)
    assert tuple(yt.shape) == (2, 5, 48)
    np.testing.assert_allclose(to_np(yt), to_np(yj), **TOL)


@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_linear_apply_fused_lora_matches_jax(case, monkeypatch):
    """On the kernel path, packed-INT sites with 2-D LoRA and at least
    ``FUSED_LORA_MIN_ROWS`` rows of x go through the fused wrapper; every
    branch still matches the JAX package's (unfused) ``linear_apply``."""
    from repro_torch.kernels import ops as kops
    calls = []
    real = kops.dequant_matmul_lora

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(kops, "dequant_matmul_lora", spy)
    pj, pt = _both(LINEAR_CASES[case]())
    x = _np(2, -(-kops.FUSED_LORA_MIN_ROWS // 2), 64)
    yj = jmod.linear_apply(pj, jnp.asarray(x), jmod.QSpec(use_kernel=True))
    yt = tmod.linear_apply(pt, torch.from_numpy(x),
                           tmod.QSpec(use_kernel=True))
    np.testing.assert_allclose(to_np(yt), to_np(yj), **TOL)
    fusable = ("qcodes" in pt and "absmax" not in pt and "lora_a" in pt
               and pt["lora_a"].dim() == 2)
    assert len(calls) == int(fusable)


def test_norms_embedding_head_mlp():
    x = _np(2, 3, 64)
    p = {"scale": _np(64) + 1.0, "bias": _np(64)}
    pj, pt = _both(p)
    np.testing.assert_allclose(
        to_np(tmod.rmsnorm_apply(pt, torch.from_numpy(x))),
        to_np(jmod.rmsnorm_apply(pj, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        to_np(tmod.layernorm_apply(pt, torch.from_numpy(x))),
        to_np(jmod.layernorm_apply(pj, jnp.asarray(x))), **TOL)
    ej, et = _both({"w": _np(40, 64)})
    tok = np.array([[1, 39, 0], [7, 7, 2]], np.int32)
    np.testing.assert_array_equal(
        to_np(tmod.embedding_apply(et, torch.from_numpy(tok))),
        to_np(jmod.embedding_apply(ej, jnp.asarray(tok))))
    for head in ({"w": _np(40, 64)}, {"w": _np(64, 40)}):     # tied, untied
        hj, ht = _both(head)
        np.testing.assert_allclose(
            to_np(tmod.lm_head_apply(ht, torch.from_numpy(x))),
            to_np(jmod.lm_head_apply(hj, jnp.asarray(x))), **TOL)
    mp = {"gate": {"w": _np(64, 96, scale=0.1)},
          "up": {"w": _np(64, 96, scale=0.1)},
          "down": {"w": _np(96, 64, scale=0.1)}}
    mj, mt = _both(mp)
    np.testing.assert_allclose(
        to_np(tmlp.swiglu_apply(mt, torch.from_numpy(x))),
        to_np(jmlp.swiglu_apply(mj, jnp.asarray(x))), **TOL)
    gp = {"up": {"w": _np(64, 96, scale=0.1), "b": _np(96)},
          "down": {"w": _np(96, 64, scale=0.1), "b": _np(64)}}
    gj, gt = _both(gp)
    np.testing.assert_allclose(
        to_np(tmlp.gelu_mlp_apply(gt, torch.from_numpy(x))),
        to_np(jmlp.gelu_mlp_apply(gj, jnp.asarray(x))), **TOL)


def test_rope_and_masks():
    x = _np(2, 6, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4, 5], [9, 10, 11, 12, 13, 14]], np.int32)
    np.testing.assert_allclose(
        to_np(ta.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        to_np(ja.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(ta.rope_freqs(16, 1e4)),
                               to_np(ja.rope_freqs(16, 1e4)), rtol=1e-6)
    for args in ((5, 5, None, 0), (3, 8, 4, 5)):
        np.testing.assert_array_equal(to_np(ta.causal_mask(*args)),
                                      to_np(ja.causal_mask(*args)))


def _jax_model(cfg_j, seed=0):
    return jt.init_params(jax.random.PRNGKey(seed), cfg_j)


@pytest.mark.parametrize("scan", [True, False])
def test_forward_logits(scan):
    cfg_j, cfg_t = configs(scan_layers=scan)
    pj = _jax_model(cfg_j)
    pt = port_params(pj, cfg_t)
    tok = RNG.integers(0, cfg_j.vocab, size=(2, 12)).astype(np.int32)
    lj, _ = jt.forward(pj, cfg_j, {"tokens": jnp.asarray(tok)})
    lt, aux = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(lt), to_np(lj), **TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_decode_steps_match(kernel):
    """Eight decode steps from the same params: logits agree at every step
    (atol 1e-4), the port feeding back the JAX argmax so both see the same
    inputs."""
    cfg_j, cfg_t = configs()
    pj = _jax_model(cfg_j, seed=1)
    pt = port_params(pj, cfg_t)
    q = dict(bits=4, group_size=16, rank=8, use_kernel=kernel)
    cfg_j = dataclasses.replace(cfg_j, quant=jmod.QSpec(**q))
    cfg_t = dataclasses.replace(cfg_t, quant=tmod.QSpec(**q))
    B, T = 3, 16
    cj = jt.init_decode_cache(cfg_j, B, T)
    ct = tt.init_decode_cache(cfg_t, B, T, device="cpu")
    tok = np.array([[5], [100], [511]], np.int32)
    step_j = jax.jit(lambda p, c, t: jt.decode_step(p, cfg_j, c, t))
    for _ in range(8):
        lj, cj = step_j(pj, cj, jnp.asarray(tok))
        lt, ct = tt.decode_step(pt, cfg_t, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(to_np(lt), to_np(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj, axis=-1))[:, None].astype(np.int32)
    assert int(ct["idx"]) == 8
    np.testing.assert_allclose(to_np(ct["k"]), to_np(cj["k"]), **TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_attn_decode_vector_idx(kernel):
    cfg = ja.AttnConfig(64, 4, 2, 16, qk_norm=True)
    tcfg = ta.AttnConfig(64, 4, 2, 16, qk_norm=True)
    p = {n: {"w": _np(64, 64 if n in "qo" else 32, scale=0.1)}
         for n in "qkvo"}
    p["q_norm"] = {"scale": _np(16) + 1.0}
    p["k_norm"] = {"scale": _np(16) + 1.0}
    pj, pt = _both(p)
    B, T = 3, 8
    K = _np(B, T, 2, 16)
    V = _np(B, T, 2, 16)
    idx = np.array([0, 3, 7], np.int32)
    x = _np(B, 1, 64)
    yj, cj = ja.attn_decode(pj, cfg, jnp.asarray(x),
                            {"k": jnp.asarray(K), "v": jnp.asarray(V),
                             "idx": jnp.asarray(idx)},
                            qspec=jmod.QSpec(use_kernel=kernel))
    yt, ct = ta.attn_decode(pt, tcfg, torch.from_numpy(x),
                            {"k": torch.from_numpy(K.copy()),
                             "v": torch.from_numpy(V.copy()),
                             "idx": torch.from_numpy(idx)},
                            qspec=tmod.QSpec(use_kernel=kernel))
    np.testing.assert_allclose(to_np(yt), to_np(yj), **TOL)
    np.testing.assert_allclose(to_np(ct["k"]), to_np(cj["k"]), **TOL)
    np.testing.assert_array_equal(to_np(ct["idx"]), to_np(cj["idx"]))


def test_attn_decode_sliding_window_ring():
    cfg = ja.AttnConfig(32, 2, 1, 16, sliding_window=4)
    tcfg = ta.AttnConfig(32, 2, 1, 16, sliding_window=4)
    p = {n: {"w": _np(32, 32 if n in "qo" else 16, scale=0.1)}
         for n in "qkvo"}
    pj, pt = _both(p)
    cj = {"k": jnp.zeros((2, 4, 1, 16)), "v": jnp.zeros((2, 4, 1, 16)),
          "idx": jnp.asarray(0, jnp.int32)}
    ct = {"k": torch.zeros(2, 4, 1, 16), "v": torch.zeros(2, 4, 1, 16),
          "idx": torch.tensor(0, dtype=torch.int32)}
    for _ in range(6):                       # wraps the ring once
        x = _np(2, 1, 32)
        yj, cj = ja.attn_decode(pj, cfg, jnp.asarray(x), cj)
        yt, ct = ta.attn_decode(pt, tcfg, torch.from_numpy(x), ct)
        np.testing.assert_allclose(to_np(yt), to_np(yj), **TOL)


def test_init_params_layout_and_scales():
    cfg_j, cfg_t = configs()
    pj = _jax_model(cfg_j)
    pt = tt.init_params(cfg_t, seed=0, device="cpu")
    from repro.utils import tree_paths as jpaths
    from repro_torch.utils import tree_paths as tpaths
    sj = {k: (tuple(v.shape), str(v.dtype)) for k, v in jpaths(pj).items()}
    st = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in tpaths(pt).items()}
    assert sj == st
    w = to_np(pt["blocks"]["mlp"]["down"]["w"])
    assert abs(w.std() * np.sqrt(cfg_t.d_ff) - 1.0) < 0.05
    assert abs(to_np(pt["embed"]["w"]).std() / 0.02 - 1.0) < 0.05
    eager = tt.init_params(dataclasses.replace(cfg_t, scan_layers=False),
                           seed=0, device="cpu")
    assert sorted(eager["blocks"]) == ["0", "1"]
    np.testing.assert_array_equal(to_np(eager["blocks"]["1"]["attn"]["q"]
                                        ["w"]),
                                  to_np(pt["blocks"]["attn"]["q"]["w"][1]))
