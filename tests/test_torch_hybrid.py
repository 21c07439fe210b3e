"""Port parity: the hybrid family (Zamba2-style Mamba layers plus one
weight-shared attention + MLP block with per-site LoRA) against the JAX
package, on the CPU: the model, calibration, CLoQ's per-site adapters,
both quantization engines, the health guard on a site Gram, the
fixed-slot serving loop and the CLIs.

The same numpy params and inputs go through ``repro`` and
``repro_torch``.  Tolerances: logits, losses, LoRA gradients, decode and
Grams within 1e-4 (atol and rtol; f32 sums in another order), the port's
rule for f32 paths; quantized leaves within the reference's
batched-vs-sequential oracle (``tests/test_batched.py``: code flips within
0.005, float leaves and ``A @ B^T`` within 1e-3 relative Frobenius);
greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cloq as jcloq
from repro.core import faults as jfaults
from repro.core import pipeline as jp
from repro.core.health import HealthReport as JReport
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import transformer as jt
from repro.models.modules import QSpec as JQSpec
from repro.utils import tree_paths as jpaths
from repro_torch.core import cloq as tcloq
from repro_torch.core import faults as tfaults
from repro_torch.core import pipeline as tp
from repro_torch.core.health import HealthReport
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.utils import tree_paths as tpaths
from tests.test_torch_batched import (FLIP_BUDGET, REL, _assert_leaves_close,
                                      _rel_fro)
from tests.test_torch_ssm import _batches, _lora_grads_match
from tests.torch_parity import jax_to_numpy, port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
QS = dict(bits=2, group_size=16, rank=8)
SHARED = ("attn.k", "attn.o", "attn.q", "attn.v", "mlp.down", "mlp.gate",
          "mlp.up")


@pytest.fixture(scope="module", params=[True, False], ids=["scan", "eager"])
def smoke(request):
    """Zamba2-7B's smoke model (6 Mamba layers, the shared block after
    layers 3 and 6, a 32-position window) with LoRA rank 4 on the Mamba
    linears and every site's ``lora_b`` drawn, in either layout."""
    from repro import configs as jc
    from repro_torch import configs as tc
    kw = dict(lora_rank=4, scan_layers=request.param)
    cfg_j = jc.get_smoke_config("zamba2-7b", **kw)
    cfg_t = tc.get_smoke_config("zamba2-7b", **kw)
    pn = jax_to_numpy(jt.init_params(jax.random.PRNGKey(5), cfg_j))
    rng = np.random.default_rng(6)
    for path, leaf in jpaths(pn).items():
        if path.endswith("lora_b"):
            node = pn
            for k in path.split(".")[:-1]:
                node = node[k]
            node["lora_b"] = (rng.normal(size=leaf.shape)
                              * 0.05).astype(np.float32)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn), port_params(pn, cfg_t)


def test_shared_block_and_site_stacks_are_the_references(smoke):
    """``init_params``' ``shared`` subtree: the reference's leaves and
    shapes (site stacks ``(2, m, max(rank, 8))``), no adapter on the
    shared block's own linears."""
    cfg_j, cfg_t, pj, pt = smoke
    mine = tpaths(tt.init_params(cfg_t, seed=0, device="cpu")["shared"])
    ref = jpaths(pj["shared"])
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == tuple(v.shape), k
    assert tuple(mine["site_lora.mlp_down.lora_a"].shape) == (2, 128, 8)
    assert not any(k.startswith("block.") and "lora" in k for k in mine)


def test_forward_loss_and_site_grads_match_jax(smoke):
    """Logits and ``loss_fn`` in both layouts; in the scan layout every
    LoRA gradient, the per-site stacks' included."""
    cfg_j, cfg_t, pj, pt = smoke
    batch_j, batch_t = _batches(np.random.default_rng(7), cfg_j.vocab,
                                (2, 16))
    lj, _ = jt.forward(pj, cfg_j, batch_j)
    lt, _ = tt.forward(pt, cfg_t, batch_t)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    if cfg_t.scan_layers:
        _lora_grads_match(cfg_j, cfg_t, pj, pt, batch_j, batch_t,
                          "shared.site_lora.mlp_down")
    else:
        np.testing.assert_allclose(
            tt.loss_fn(pt, cfg_t, batch_t)[0].item(),
            float(jt.loss_fn(pj, cfg_j, batch_j)[0]), **TOL)


def test_decode_wraps_the_window_ring_as_jax(smoke):
    """Twelve greedy decode steps at batch 2 into an 8-position cache: the
    shared block's K/V ring (``min(cache_len, hybrid_window)`` = 8) wraps
    after 8 steps.  Logits within 1e-4 and equal tokens each step; the
    port's caches keep their tensors (written in place)."""
    cfg_j, cfg_t, pj, pt = smoke
    cj = jt.init_decode_cache(cfg_j, 2, 8)
    ct = tt.init_decode_cache(cfg_t, 2, 8, device="cpu")
    assert tuple(ct["shared_kv"]["k"].shape) == (2, 2, 8, 4, 16)
    ring, state = ct["shared_kv"]["k"], ct["state"]
    tok = np.array([[5], [300]], np.int32)
    tj, tk = jnp.asarray(tok), torch.from_numpy(tok)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, cfg_j, c, t))
    for _ in range(12):
        lj, cj = step(pj, cj, tj)
        lt, ct = tt.decode_step(pt, cfg_t, ct, tk)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tk = lt.argmax(-1, keepdim=True)
        assert np.array_equal(np.asarray(tj), to_np(tk))
    np.testing.assert_allclose(to_np(ct["shared_kv"]["k"]),
                               np.asarray(cj["shared_kv"]["k"]), **TOL)
    assert ct["shared_kv"]["k"] is ring and ct["state"] is state


# -- calibration and quantization ----------------------------------------------


def _oracle_cfgs():
    """``tests/test_batched.py::test_model_parity_hybrid_shared_block``'s
    model: 4 Mamba layers, the shared block every 2 (2 sites), f32."""
    base = dict(name="t", family="hybrid", n_layers=4, d_model=32,
                vocab=128, n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64,
                ssm_state=16, ssm_head_dim=16, ssm_groups=2, ssm_chunk=8,
                hybrid_attn_every=2, hybrid_window=16)
    return (jt.ModelConfig(**base, dtype=jnp.float32),
            tt.ModelConfig(**base, dtype=torch.float32))


@pytest.fixture(scope="module")
def oracle():
    """The oracle model, the JAX batched engine's CLoQ 2-bit g16 r8
    quantization of it and its Grams."""
    from repro.data import DataConfig as JDC
    from repro.data import TokenStream as JTS
    from repro_torch.data import DataConfig as TDC
    from repro_torch.data import TokenStream as TTS
    cfg_j, cfg_t = _oracle_cfgs()
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    kw = dict(vocab=128, seq_len=32, global_batch=2, seed=3)
    cj, ct = [JTS(JDC(**kw)).next_batch()], [TTS(TDC(**kw)).next_batch()]
    qj, qcfg_j, sj = jp.quantize_model(
        pj, cfg_j, cj, recipe=JRecipe.single("cloq", JQSpec(**QS)))
    return (cfg_j, cfg_t, pj, port_params(pj, cfg_t), cj, ct,
            jpaths(jax_to_numpy(jp.to_eager_params(qj, qcfg_j))), sj,
            (qj, qcfg_j))


def _site_prods(flat: dict, lin: str) -> np.ndarray:
    key = f"shared.site_lora.{lin.replace('.', '_')}"
    return np.einsum("smr,snr->smn", to_np(flat[f"{key}.lora_a"]),
                     to_np(flat[f"{key}.lora_b"]))


def test_calibration_keys_are_the_references(oracle):
    """``run_calibration``: the Mamba linears' Grams and one Gram a shared
    linear a site under ``sites.<s>.shared.<mod>.<lin>``, the reference's
    keys, values and counts."""
    cfg_j, cfg_t, _, pt, _, ct, _, sj, _ = oracle
    st = tp.run_calibration(pt, cfg_t, ct)
    assert sorted(st.grams) == sorted(sj.grams)
    assert sorted(k for k in st.grams if k.startswith("sites.")) == sorted(
        f"sites.{s}.shared.{lin}" for s in (0, 1) for lin in SHARED)
    for k, h in st.grams.items():
        np.testing.assert_allclose(to_np(h), np.asarray(sj.grams[k]),
                                   err_msg=k, **TOL)
        assert st.counts[k] == sj.counts[k]


def test_cloq_site_lora_matches_jax():
    """One closed-form solve a site against its own Gram: ``A @ B^T`` of
    each site within 1e-4 of JAX's (the factors themselves are defined up
    to the SVD's signs), the two sites' different; a rank above ``n``
    comes out at ``n`` as JAX's; a sequence of Grams gives the stacked
    call's adapters (the sharded solve: tests/test_torch_distributed.py)."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(2, 40, 24)).astype(np.float32)
    Hs = np.einsum("stm,stn->smn", X, X)
    dW = (rng.normal(size=(24, 6)) * 0.1).astype(np.float32)
    for rank in (4, 8):
        A, B = tcloq.cloq_site_lora(torch.from_numpy(Hs),
                                    torch.from_numpy(dW), rank)
        Aj, Bj = jcloq.cloq_site_lora(jnp.asarray(Hs), jnp.asarray(dW), rank)
        assert tuple(A.shape) == tuple(Aj.shape) == (2, 24, min(rank, 6))
        got = np.einsum("smr,snr->smn", to_np(A), to_np(B))
        want = np.einsum("smr,snr->smn", np.asarray(Aj), np.asarray(Bj))
        np.testing.assert_allclose(got, want, **TOL)
        if rank < 6:
            assert _rel_fro(got[0], got[1]) > 1e-2
    A, B = tcloq.cloq_site_lora(torch.from_numpy(Hs), torch.from_numpy(dW),
                                4)
    A2, B2 = tcloq.cloq_site_lora(list(torch.from_numpy(Hs)),
                                  torch.from_numpy(dW), 4)
    assert torch.equal(A, A2) and torch.equal(B, B2)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_quantize_hybrid_model_matches_jax(oracle, engine):
    """Both port engines against JAX's batched engine: the shared base
    (quantized once against the pooled site Gram) and every Mamba site in
    the reference's oracle terms, each site's ``A @ B^T`` within 1e-3
    relative of JAX's, no adapter on the shared block's own linears, the
    health guards clean (one check a Mamba linear and a shared linear);
    the Mamba leaves that are not linears carried unchanged in f32."""
    _, cfg_t, _, pt, _, ct, lj, _, _ = oracle
    report = HealthReport()
    qt, qcfg, _ = tp.quantize_model(
        pt, cfg_t, ct, engine=engine, report=report,
        recipe=TRecipe.single("cloq", TQSpec(**QS)))
    assert report.checked == 4 * 5 + 7 and not report.counts()
    lt = tpaths(tp.to_eager_params(qt, qcfg))
    assert sorted(lt) == sorted(lj)
    assert not any(k.startswith("shared.block.") and "lora" in k for k in lt)
    sites = sorted({p.rsplit(".", 1)[0] for p in lj if p.endswith("qcodes")})
    assert len(sites) == 4 * 5 + 7
    for site in sites:
        keys = [k for k in ("qcodes", "scales", "zeros", "lora_a", "lora_b")
                if f"{site}.{k}" in lj]
        if site.startswith("shared.block."):
            for k in keys:
                g, w = to_np(lt[f"{site}.{k}"]), lj[f"{site}.{k}"]
                assert g.shape == w.shape, (site, k)
                if g.dtype == np.uint8:
                    assert float(np.mean(g != w)) <= FLIP_BUDGET, (site, k)
                else:
                    assert _rel_fro(g, w) <= REL, (site, k)
            continue
        _assert_leaves_close({k: lt[f"{site}.{k}"] for k in keys},
                             {k: lj[f"{site}.{k}"] for k in keys})
    # dt_proj: 4 heads, so CLoQ's factors come out at rank 4, not 8
    assert tuple(lt["blocks.0.mamba.dt_proj.lora_a"].shape) == (32, 4)
    for k in ("a_log", "d", "dt_bias", "conv_x"):
        assert torch.equal(lt[f"blocks.1.mamba.{k}"],
                           pt["blocks"]["mamba"][k][1])
        assert lt[f"blocks.1.mamba.{k}"].dtype == torch.float32
    for lin in SHARED:
        got, want = _site_prods(lt, lin), _site_prods(lj, lin)
        assert got.shape[0] == 2
        for s in range(2):
            assert _rel_fro(got[s], want[s]) <= REL, (lin, s)
        assert _rel_fro(got[0], got[1]) > 1e-2, lin


def test_site_order_from_eleven_sites_on():
    """12 shared-block sites (12 Mamba layers, the block after each): the
    port's stacked adapter at index ``s`` is ``cloq_init`` against site
    ``s``'s own (regularized) Gram with the shared residual, as ``A @
    B^T``; the JAX package stacks its sites in the string order of their
    keys (``sites.10`` before ``sites.2``), and its stack reordered to
    number order matches the port's within the hybrid tests' 1e-3."""
    cfg_j, cfg_t = (dataclasses.replace(c, n_layers=12, hybrid_attn_every=1)
                    for c in _oracle_cfgs())
    assert cfg_t.n_hybrid_sites == 12
    from repro_torch.data import DataConfig as TDC
    from repro_torch.data import TokenStream as TTS
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = port_params(pj, cfg_t)
    calib = [TTS(TDC(vocab=128, seq_len=32, global_batch=2,
                     seed=3)).next_batch()]
    recipe = dict(bits=4, group_size=16, rank=8)
    qt, qcfg, store = tp.quantize_model(
        pt, cfg_t, calib, recipe=TRecipe.single("cloq", TQSpec(**recipe)))
    qj, qcfg_j, _ = jp.quantize_model(
        pj, cfg_j, [{k: v.numpy() for k, v in calib[0].items()}],
        recipe=JRecipe.single("cloq", JQSpec(**recipe)))
    lt = tpaths(tp.to_eager_params(qt, qcfg))
    lj = jpaths(jax_to_numpy(jp.to_eager_params(qj, qcfg_j)))
    string_order = [int(k) for k in sorted(str(s) for s in range(12))]
    assert string_order[:4] == [0, 1, 10, 11]
    W0 = tpaths(pt)
    for lin in ("attn.q", "mlp.down"):
        got = _site_prods(lt, lin)
        node = {k: lt[f"shared.block.{lin}.{k}"]
                for k in ("qcodes", "scales", "zeros")}
        m = W0[f"shared.block.{lin}.w"].shape[0]
        dW = W0[f"shared.block.{lin}.w"].float() - \
            tp._shared_base_dequant(node, m, TQSpec(**recipe))
        for s in range(12):
            H = store.grams[f"sites.{s}.shared.{lin}"]
            A, B = tcloq.cloq_init(tcloq.regularize_gram(H), dW, 8)
            assert _rel_fro(got[s], to_np(A @ B.T)) <= REL, (lin, s)
        want = _site_prods(lj, lin)
        reordered = np.empty_like(want)
        reordered[string_order] = want
        for s in range(12):
            assert _rel_fro(got[s], reordered[s]) <= REL, (lin, s)
        assert _rel_fro(got[2], want[2]) > 1e-2, lin


SITE = "sites.0.shared.attn.q"


def test_gram_nan_at_a_site_is_healed_alike_in_both_engines(oracle):
    """``gram_nan`` at site 0's Gram of the shared q: in both engines that
    site's adapter is healed by the identity Gram (the same record as the
    JAX engine's) within 1e-3 of JAX's healed adapter, site 1's and the
    shared base are the clean run's, and every leaf is finite."""
    cfg_j, cfg_t, pj, pt, cj, ct, lj, _, _ = oracle
    jrep = JReport()
    with jfaults.inject("gram_nan", match=SITE):
        qj, qcfg_j, _ = jp.quantize_model(
            pj, cfg_j, cj, recipe=JRecipe.single("cloq", JQSpec(**QS)),
            report=jrep)
    lj_bad = jpaths(jax_to_numpy(jp.to_eager_params(qj, qcfg_j)))
    want = _site_prods(lj_bad, "attn.q")
    outs = {}
    for engine in ("batched", "sequential"):
        report = HealthReport()
        with tfaults.inject("gram_nan", match=SITE):
            qt, qcfg, _ = tp.quantize_model(
                pt, cfg_t, ct, engine=engine, report=report,
                recipe=TRecipe.single("cloq", TQSpec(**QS)))
        lt = tpaths(tp.to_eager_params(qt, qcfg))
        assert report.counts() == jrep.counts() == {
            "recovered_identity_gram": 1}
        assert set(report.records) == set(jrep.records) == {
            "shared.block.attn.q"}
        assert all(bool(torch.isfinite(v).all()) for v in lt.values()
                   if v.is_floating_point())
        got = _site_prods(lt, "attn.q")
        assert _rel_fro(got[0], want[0]) <= REL
        np.testing.assert_allclose(got[1], _site_prods(lj, "attn.q")[1],
                                   rtol=REL, atol=REL)
        outs[engine] = got
    assert _rel_fro(outs["batched"][0], outs["sequential"][0]) <= REL


# -- serving and the CLIs -------------------------------------------------------


def test_fixed_slots_tokens_match_jax_decode(oracle):
    """The JAX-quantized oracle model carried over and served by the
    port's fixed-slot loop (batch 2, 4 requests x 6 tokens: 12 steps into
    a 12-position cache, refilled slots keeping their SSM state, as in the
    JAX loop): each step's logits within 1e-4 and its greedy tokens equal
    to the JAX ``decode_step`` driven over the same inputs."""
    from repro_torch.launch import serve
    cfg_t, (qj, qcfg_j) = oracle[1], oracle[-1]
    qcfg_t = dataclasses.replace(cfg_t, quant=TQSpec(**QS))
    qt = port_params(qj, qcfg_t)
    res = serve.serve_fixed_slots(qt, qcfg_t, batch=2, cache_len=12,
                                  requests=4, max_new=6, seed=1,
                                  device="cpu", keep_logits=True)
    assert res["requests_done"] == 4 and res["steps"] == 12
    cache = jt.init_decode_cache(qcfg_j, 2, 12)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, qcfg_j, c, t))
    for inp, out, lt in zip(res["inputs"], res["outputs"], res["logits"]):
        lj, cache = step(qj, cache, jnp.asarray(inp[:, None].astype(np.int32)))
        np.testing.assert_allclose(lt, np.asarray(lj), **TOL)
        assert np.array_equal(np.asarray(jnp.argmax(lj, -1)), out)


def test_train_and_serve_clis_run_zamba2(capsys):
    """``repro_torch.launch.train --arch zamba2-7b --smoke --device cpu``:
    6 x 5 Mamba linears and 7 shared linears checked clean, the per-site
    adapters among the trained leaves, finite losses.  ``repro_torch.
    launch.serve --arch zamba2-7b --smoke --device cpu`` takes the
    fixed-slot loop; the engine refuses the family."""
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import full_trainable_mask
    from repro_torch.serve import ServeEngine
    assert train.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--batch", "2",
                       "--calib-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "health: 37 slices checked, all clean" in out, out
    assert "[done]" in out
    res = serve.run(serve.build_parser().parse_args(
        ["--arch", "zamba2-7b", "--smoke", "--device", "cpu"]))
    s = res["serve"]
    assert res["route"] == "fixed_slots" and res["cfg"].family == "hybrid"
    assert s["requests_done"] == 8 and s["all_finite"]
    mask = tpaths(full_trainable_mask(res["params"], "lora"))
    assert mask["shared.site_lora.attn_q.lora_a"]
    assert mask["shared.site_lora.mlp_down.lora_b"]
    assert not mask["shared.block.attn.q.scales"]
    with pytest.raises(ValueError, match="fixed-slot"):
        ServeEngine(res["params"], res["cfg"], None)
