"""Port parity: the MoE family (``repro_torch.models.moe`` and its model,
quantization, serving and CLI paths) against the JAX package, on the CPU.

The same numpy params and inputs go through ``repro`` and
``repro_torch`` (JAX params carried over with ``convert.params_from_jax``).
Tolerances: the MoE block, the logits, losses and LoRA gradients of the
f32 smoke models within 1e-4 (atol and rtol; f32 matmuls summed in another
order), the port's rule for f32 paths; expert Grams within 1e-5 and exactly
symmetric; quantized models within the reference's batched-vs-sequential
oracle (``tests/test_batched.py``: code flips within 0.005, float leaves
and ``A @ B^T`` within 1e-3 relative Frobenius); greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import AdapterRegistry as JaxRegistry
from repro.serve import ServeEngine as JaxEngine
from repro.serve import adapters_from_tree as jax_adapters
from repro.serve import run_workload as jax_run_workload
from repro.serve.registry import synthesize_adapters as jax_synth
from repro.utils import GramStore as JStore
from repro.utils import tree_paths as jpaths
from repro_torch.core import faults
from repro_torch.core import health as th
from repro_torch.core import pipeline as tp
from repro_torch.core.health import HealthReport
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.serve import (AdapterRegistry, ServeEngine,
                               adapters_from_tree, run_workload)
from repro_torch.serve.registry import synthesize_adapters
from repro_torch.utils import GramStore as TStore
from repro_torch.utils import set_path
from repro_torch.utils import tree_paths as tpaths
from tests.test_torch_batched import _assert_leaves_close
from tests.torch_parity import jax_to_numpy, port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
QKEYS = ("qcodes", "scales", "zeros", "absmax", "lora_a", "lora_b")


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_apply_and_aux_match_jax(capacity_factor):
    """``tests/test_models.py``'s MoE case: generous capacity (no drops)
    and tight capacity (the reference's drop case).  Output and aux loss
    within 1e-4: a token dropped on one side only would move its row by
    O(1), so equal outputs mean the same tokens were dropped."""
    kw = dict(n_experts=4, top_k=2, d_model=16, d_ff=32,
              capacity_factor=capacity_factor)
    pj = jmoe.moe_init(jax.random.PRNGKey(4), jmoe.MoEConfig(**kw),
                       dtype=jnp.float32, lora_rank=4)
    rng = np.random.default_rng(1)
    pn = jax_to_numpy(pj)
    for name in ("gate", "up", "down"):       # non-zero expert LoRA terms
        pn[name]["lora_b"] = _np(rng, *pn[name]["lora_b"].shape, scale=0.1)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pn)
    x = _np(rng, 2, 8, 16)
    yj, auxj = jmoe.moe_apply(jax.tree.map(jnp.asarray, pn),
                              jmoe.MoEConfig(**kw), jnp.asarray(x))
    with tmoe.record_drops() as log:
        yt, auxt = tmoe.moe_apply(pt, tmoe.MoEConfig(**kw),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(to_np(yt), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    (dropped, routed), = log
    assert routed == 2 * 8 * 2
    assert (int(dropped) > 0) == (capacity_factor < 1), int(dropped)


def test_gram_store_keep_leading_matches_jax():
    """One f32 Gram an expert from (E, C, D) buffers, summed over batches:
    the JAX store's ``einsum`` within 1e-5, each expert's exactly
    symmetric, the same counts."""
    rng = np.random.default_rng(2)
    js, ts = JStore(), TStore()
    for _ in range(2):
        x = _np(rng, 3, 5, 24)
        js.add("e", jnp.asarray(x), keep_leading=True)
        ts.add("e", torch.from_numpy(x), keep_leading=True)
    h = ts.gram("e")
    assert tuple(h.shape) == (3, 24, 24) and torch.equal(h, h.mT)
    np.testing.assert_allclose(to_np(h), np.asarray(js.gram("e")),
                               rtol=1e-5, atol=1e-5)
    assert ts.counts["e"] == js.counts["e"] == 10


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """A MoE smoke model with LoRA on every linear and expert (``lora_b``
    drawn, so every adapter gets a gradient), JAX params carried over."""
    from repro import configs as jc
    from repro_torch import configs as tc
    cfg_j = jc.get_smoke_config(request.param, lora_rank=4)
    cfg_t = tc.get_smoke_config(request.param, lora_rank=4)
    rng = np.random.default_rng(3)
    pn = jax_to_numpy(jt.init_params(jax.random.PRNGKey(5), cfg_j))
    for path, leaf in jpaths(pn).items():
        if path.endswith("lora_b"):
            node = pn
            for k in path.split(".")[:-1]:
                node = node[k]
            node["lora_b"] = _np(rng, *leaf.shape, scale=0.05)
    pj = jax.tree.map(jnp.asarray, pn)
    return cfg_j, cfg_t, pj, port_params(pn, cfg_t)


def test_forward_loss_and_lora_grads_match_jax(smoke):
    """``forward`` (logits and the summed aux loss), ``loss_fn`` and the
    gradients of every LoRA leaf, attention and experts."""
    cfg_j, cfg_t, pj, pt = smoke
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_j.vocab, (2, 12)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(toks)}
    lj, auxj = jt.forward(pj, cfg_j, batch_j)
    lt, auxt = tt.forward(pt, cfg_t, batch_t)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    assert float(auxt) > 0

    gj = jax.grad(lambda p: jt.loss_fn(p, cfg_j, batch_j)[0])(pj)
    flat = tpaths(pt)
    lora = sorted(p for p in flat if p.endswith(("lora_a", "lora_b")))
    assert any(".moe." in p for p in lora)
    leaves = [flat[p].clone().requires_grad_(True) for p in lora]
    live = tpaths(pt)
    live.update(zip(lora, leaves))
    tree: dict = {}
    for p, v in live.items():
        set_path(tree, p, v)
    loss_t, (ce_t, _) = tt.loss_fn(tree, cfg_t, batch_t)
    loss_j, (ce_j, _) = jt.loss_fn(pj, cfg_j, batch_j)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    grads = torch.autograd.grad(loss_t, leaves)
    gflat = jpaths(gj)
    for p, g in zip(lora, grads):
        np.testing.assert_allclose(to_np(g), np.asarray(gflat[p]),
                                   err_msg=p, **TOL)


def test_decode_steps_match_jax(smoke):
    """Four greedy decode steps at batch 3 from the same caches."""
    cfg_j, cfg_t, pj, pt = smoke
    cj = jt.init_decode_cache(cfg_j, 3, 8)
    ct = tt.init_decode_cache(cfg_t, 3, 8, device="cpu")
    tok = np.array([[3], [17], [101]], np.int32)
    tj, tk = jnp.asarray(tok), torch.from_numpy(tok)
    for _ in range(4):
        lj, cj = jt.decode_step(pj, cfg_j, cj, tj)
        lt, ct = tt.decode_step(pt, cfg_t, ct, tk)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tk = lt.argmax(-1, keepdim=True)
        assert np.array_equal(np.asarray(tj), to_np(tk))


# -- quantization ------------------------------------------------------------


def _moe_cfgs(**kw):
    """``tests/test_batched.py::test_model_parity_moe_stacked_experts``'s
    model (2 layers, d_model 32, 4 experts top-2, expert d_ff 32, f32)."""
    base = dict(name="t", family="moe", n_layers=2, d_model=32, vocab=128,
                n_heads=4, n_kv_heads=2, n_experts=4, top_k=2,
                d_ff_expert=32, **kw)
    return (jt.ModelConfig(**base, dtype=jnp.float32),
            tt.ModelConfig(**base, dtype=torch.float32))


@pytest.fixture(scope="module")
def moe_model():
    from repro.data import DataConfig as JDC
    from repro.data import TokenStream as JTS
    from repro_torch.data import DataConfig as TDC
    from repro_torch.data import TokenStream as TTS
    cfg_j, cfg_t = _moe_cfgs()
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    kw = dict(vocab=128, seq_len=32, global_batch=2, seed=3)
    return (cfg_j, cfg_t, pj, port_params(pj, cfg_t),
            [JTS(JDC(**kw)).next_batch()], [TTS(TDC(**kw)).next_batch()])


def _sites(flat: dict) -> list[str]:
    return sorted({p.rsplit(".", 1)[0] for p in flat if p.endswith("qcodes")})


def test_quantize_moe_model_matches_jax(moe_model):
    """CLoQ 4-bit g16 r8 through the port's batched and sequential
    engines against JAX's batched engine: every site, stacked expert
    sites included (their leaves keep the leading E), within the
    reference's oracle; both port runs clean under the health guards, one
    health check an expert; expert slices share a bucket with the 2-D
    sites of their shape (2 buckets: 32 x 16 and 32 x 32)."""
    from repro.core.recipe import QuantRecipe as JRecipe
    from repro.models.modules import QSpec as JQSpec
    from repro_torch.core.recipe import QuantRecipe as TRecipe
    cfg_j, cfg_t, pj, pt, cj, ct = moe_model
    qs = dict(bits=4, group_size=16, rank=8)
    qj, qcfg_j, _ = jp.quantize_model(
        pj, cfg_j, cj, recipe=JRecipe.single("cloq", JQSpec(**qs)),
        engine="batched")
    lj = jpaths(jax_to_numpy(jp.to_eager_params(qj, qcfg_j)))
    sites = _sites(lj)
    assert len(sites) == 2 * (4 + 3)
    msgs: list[str] = []
    for engine in ("batched", "sequential"):
        report = HealthReport()
        qt, qcfg, _ = tp.quantize_model(
            pt, cfg_t, ct, recipe=TRecipe.single("cloq", TQSpec(**qs)),
            engine=engine, report=report,
            progress=msgs.append if engine == "batched" else None)
        assert report.checked == 2 * (4 + 3 * 4) and not report.counts()
        lt = {k: to_np(v) for k, v in
              tpaths(tp.to_eager_params(qt, qcfg)).items()}
        assert sorted(lt) == sorted(lj)
        for site in sites:
            keys = [k for k in QKEYS if f"{site}.{k}" in lj]
            got = {k: lt[f"{site}.{k}"] for k in keys}
            want = {k: lj[f"{site}.{k}"] for k in keys}
            if ".moe." not in site:
                _assert_leaves_close(got, want)
                continue
            assert got["qcodes"].shape[0] == 4 and got["qcodes"].ndim == 3
            for e in range(4):                 # the oracle, expert by expert
                _assert_leaves_close({k: v[e] for k, v in got.items()},
                                     {k: v[e] for k, v in want.items()})
        np.testing.assert_array_equal(lt["blocks.0.moe.router.w"],
                                      lj["blocks.0.moe.router.w"])
    assert len(msgs) == 2 and all("chunks=1" in m for m in msgs)


def test_expert_keys_equal_across_engines(moe_model):
    """RTN draws each expert's random ``A`` from its own generator,
    seeded from (seed, site index, expert): bit-equal in both engines,
    different from expert to expert."""
    from repro_torch.core.recipe import QuantRecipe as TRecipe
    _, cfg_t, _, pt, _, ct = moe_model
    recipe = TRecipe.single("rtn", TQSpec(bits=4, group_size=16, rank=8))
    got = [tpaths(tp.quantize_model(pt, cfg_t, ct, recipe=recipe,
                                    engine=e)[0])
           for e in ("batched", "sequential")]
    a = got[0]["blocks.moe.up.lora_a"]
    assert tuple(a.shape) == (2, 4, 32, 8)
    assert torch.equal(a, got[1]["blocks.moe.up.lora_a"])
    assert not torch.equal(a[0, 0], a[0, 1])


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_expert_left_dense_leaves_the_stacked_site_dense(moe_model, engine,
                                                         monkeypatch):
    """A ``gram_nan`` fault at one expert (its key ``path[e]``, escaped
    for the glob) with a ladder that accepts no rung: that expert ends
    ``fallback_dense``, the JAX twin's event is logged, and the whole
    stacked site keeps its dense ``w``; every other expert of the site
    was quantized and checked, nothing else was touched."""
    from repro_torch.core.recipe import QuantRecipe as TRecipe
    cfg_j, _, pj, _, _, ct = moe_model
    cfg_t = dataclasses.replace(_moe_cfgs()[1], scan_layers=False)
    pt = port_params(pj, cfg_t)
    site = "blocks.1.moe.up"
    monkeypatch.setattr(th, "_try_rung", lambda *a, **k: None)
    report = HealthReport()
    with faults.inject("gram_nan", match=site + "[[]2]"):
        qt, _, _ = tp.quantize_model(
            pt, cfg_t, ct, engine=engine, report=report,
            recipe=TRecipe.single("cloq", TQSpec(bits=4, group_size=16,
                                                 rank=8)))
    assert report.counts() == {"fallback_dense": 1}
    assert set(report.records) == {site + "[2]"}
    assert report.events == [f"{site}: expert degraded to dense — whole "
                             "stacked site left dense"]
    assert report.checked == 2 * (4 + 3 * 4)
    assert set(qt["blocks"]["1"]["moe"]["up"]) == {"w"}
    assert torch.equal(qt["blocks"]["1"]["moe"]["up"]["w"],
                       pt["blocks"]["1"]["moe"]["up"]["w"])
    assert "qcodes" in qt["blocks"]["1"]["moe"]["gate"]
    assert "qcodes" in qt["blocks"]["0"]["moe"]["up"]


# -- serving and the CLIs -----------------------------------------------------

MIXED = [(f"t{i % 4}", [1 + i, 2 + i, 3], 4 + i % 3) for i in range(8)]


def test_serve_engine_tokens_match_jax_engine(moe_model):
    """The MoE model quantized by JAX (CLoQ 4-bit g16 r4), carried over,
    served by both engines with 4 tenants over ranks 4 and 8: the same
    greedy tokens.  The tenants' adapters cover the attention sites only
    (the experts keep the base's CLoQ adapters), as in the JAX registry."""
    from repro.core.recipe import QuantRecipe as JRecipe
    from repro.models.modules import QSpec as JQSpec
    cfg_j, cfg_t, pj, _, cj, _ = moe_model
    qj, qcfg_j, _ = jp.quantize_model(
        pj, cfg_j, cj, recipe=JRecipe.single(
            "cloq", JQSpec(bits=4, group_size=16, rank=4)))
    qcfg_t = dataclasses.replace(cfg_t, quant=TQSpec(bits=4, group_size=16,
                                                     rank=4))
    qt = port_params(qj, qcfg_t)
    rj = JaxRegistry.from_model(qj, capacity=4)
    rt = AdapterRegistry.from_model(qt, capacity=4)
    bj, bt = jax_adapters(qj), adapters_from_tree(qt)
    assert sorted(bt) == sorted(bj) == ["attn.k", "attn.o", "attn.q",
                                        "attn.v"]
    for i in range(4):
        rank = (4, 8)[i % 2]
        rj.register(f"t{i}", jax_synth(bj, rank, seed=100 + i))
        rt.register(f"t{i}", synthesize_adapters(bt, rank, seed=100 + i))
    kw = dict(page_size=4, max_len=24, bucket_capacity=4)
    et = ServeEngine(qt, qcfg_t, rt, **kw)
    got = run_workload(et, MIXED)
    assert got == jax_run_workload(JaxEngine(qj, qcfg_j, rj, **kw), MIXED)
    assert "lora_a" in et._base["blocks"]["moe"]["up"]
    assert "lora_a" not in et._base["blocks"]["attn"]["q"]


SMOKE_FLAGS = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
               "--group-size", "16", "--rank", "8", "--seq-len", "32",
               "--batch", "2", "--calib-batches", "1"]


@pytest.mark.parametrize("method", ["cloq", "gptq", "loftq", "qlora", "rtn"])
def test_train_cli_moe_each_method(method, capsys):
    """``repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu``
    runs 2 steps with each method: every site (attention and the 3 expert
    stacks of each layer, 4 experts each) checked clean, finite losses."""
    assert ttrain.main(SMOKE_FLAGS + ["--method", method,
                                      "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "health: 32 slices checked, all clean" in out, out
    assert "[done]" in out


def test_serve_cli_moe_takes_the_engine_route():
    """``repro_torch.launch.serve --arch olmoe-1b-7b --smoke --device cpu
    --tenants 2 --ranks 8,4``: the engine serves every request."""
    args = tserve.build_parser().parse_args(
        ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
         "--tenants", "2", "--ranks", "8,4"])
    res = tserve.run(args)
    s = res["serve"]
    assert res["route"] == "engine" and res["cfg"].family == "moe"
    assert s["requests_done"] == args.requests
    assert s["rank_buckets"] == [4, 8]
    assert all(len(o) == args.max_new for o in s["outputs"])
