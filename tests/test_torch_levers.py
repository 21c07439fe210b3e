"""Port parity: the memory levers of ``ModelConfig`` (``remat``,
``attn_chunk``, with ``loss_chunk``) and ``attn_apply(q_chunk=)`` against
the JAX package, on the CPU.

The same numpy params and batches go through ``repro`` and
``repro_torch``, on the f32 smoke configs of the dense (qwen3-1.7b), MoE
(olmoe-1b-7b), hybrid (zamba2-7b) and enc-dec (seamless-m4t-medium)
families in both layouts, LoRA rank 4 on every linear with every
``lora_b`` drawn.  Tolerances are ``tests/test_perf_levers.py``'s: the
loss within 1e-5 relative, every gradient within atol 1e-5.  Within the
port each recompute policy gives the same bits as ``"none"``.  Also held:
what a policy recomputes (the fused op's calls a training step),
calibration Grams equal with and without ``remat``, and one MoE drop
record a dispatch a forward under recompute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.data import DataConfig as JDC
from repro.data import TokenStream as JTS
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.utils import tree_paths as jpaths
from repro_torch import configs as tc
from repro_torch.data import DataConfig as TDC
from repro_torch.data import TokenStream as TTS
from repro_torch.data import data_kind
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.utils import set_path
from repro_torch.utils import tree_paths as tpaths
from tests.torch_parity import jax_to_numpy, port_params, to_np

ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b", "seamless-m4t-medium")
# the levers, each as ModelConfig overrides
LEVERS = {"none": dict(remat="none"), "full": dict(remat="full"),
          "tp_out": dict(remat="tp_out"), "dots": dict(remat="dots"),
          "attn_chunk": dict(remat="none", attn_chunk=4),
          "all": dict(remat="tp_out", attn_chunk=4, loss_chunk=4)}
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5
SEQ = 16


@pytest.fixture(scope="module", params=[(a, s) for a in ARCHS
                                        for s in (True, False)],
                ids=[f"{a}-{'scan' if s else 'eager'}" for a in ARCHS
                     for s in (True, False)])
def smoke(request):
    """(arch, layout, JAX params, numpy params, a numpy batch)."""
    arch, scan = request.param
    cfg_j = jc.get_smoke_config(arch, lora_rank=4, scan_layers=scan)
    pn = jax_to_numpy(jt.init_params(jax.random.PRNGKey(5), cfg_j))
    rng = np.random.default_rng(6)
    for path, leaf in jpaths(pn).items():
        if path.endswith("lora_b"):
            node = pn
            for k in path.split(".")[:-1]:
                node = node[k]
            node["lora_b"] = (rng.normal(size=leaf.shape)
                              * 0.05).astype(np.float32)
    kw = dict(vocab=cfg_j.vocab, seq_len=SEQ, global_batch=2, seed=3,
              kind=data_kind(cfg_j), enc_len=8, n_prefix=cfg_j.n_prefix,
              d_model=cfg_j.d_model)
    batch = {k: np.asarray(v) for k, v in JTS(JDC(**kw)).next_batch().items()}
    assert all(np.array_equal(batch[k], np.asarray(v))
               for k, v in TTS(TDC(**kw)).next_batch().items())
    return arch, scan, pn, batch


def _jax_loss_grads(cfg, pn, batch):
    pj = jax.tree.map(jnp.asarray, pn)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.value_and_grad(lambda p: jt.loss_fn(p, cfg, bj)[0])(pj)
    return float(loss), {k: np.asarray(v) for k, v in jpaths(g).items()}


def _port_loss_grads(cfg, pn, batch):
    flat = tpaths(port_params(pn, cfg))
    live = {k: v.clone().requires_grad_(True) for k, v in flat.items()
            if v.is_floating_point()}
    tree: dict = {}
    for k, v in flat.items():
        set_path(tree, k, live.get(k, v))
    loss, _ = tt.loss_fn(tree, cfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.item(), {k: to_np(g) for k, g in zip(live, grads)}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_levers_loss_and_every_gradient_match_jax(smoke, lever):
    """Loss and every gradient under each lever against JAX's same
    settings; every recompute policy gives the port's ``"none"`` bits."""
    arch, scan, pn, batch = smoke
    kw = dict(lora_rank=4, scan_layers=scan, **LEVERS[lever])
    lj, gj = _jax_loss_grads(jc.get_smoke_config(arch, **kw), pn, batch)
    cfg_t = tc.get_smoke_config(arch, **kw)
    lt, gt = _port_loss_grads(cfg_t, pn, batch)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    assert set(gt) == set(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], atol=GRAD_ATOL, err_msg=k)
    if "attn_chunk" not in LEVERS[lever]:
        ln, gn = _port_loss_grads(dataclasses.replace(cfg_t, remat="none"),
                                  pn, batch)
        assert lt == ln
        assert all(np.array_equal(gt[k], gn[k]) for k in gn)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_attn_q_chunk_matches_jax(causal, window):
    """``attn_apply(q_chunk=4)`` over 16 positions against JAX's (each
    block's mask offset by its position), and against the unchunked
    port; a chunk that does not divide S runs unchunked."""
    cfg_j = jattn.AttnConfig(32, 4, 2, 8, True, 1e4, window, causal)
    cfg_t = tattn.AttnConfig(32, 4, 2, 8, True, 1e4, window, causal)
    pn = jax_to_numpy(jattn.attn_init(jax.random.PRNGKey(2), cfg_j,
                                      dtype=jnp.float32))
    pt = {k: {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
          for k, d in pn.items()}
    x = np.random.default_rng(3).normal(size=(2, 16, 32)).astype(np.float32)
    yj = jattn.attn_apply(jax.tree.map(jnp.asarray, pn), cfg_j,
                          jnp.asarray(x), q_chunk=4)
    yt = tattn.attn_apply(pt, cfg_t, torch.from_numpy(x), q_chunk=4)
    np.testing.assert_allclose(to_np(yt), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    full = tattn.attn_apply(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(yt), to_np(full), rtol=1e-5, atol=1e-6)
    odd = tattn.attn_apply(pt, cfg_t, torch.from_numpy(x), q_chunk=5)
    assert torch.equal(odd, full)


def _quantized_smoke(remat):
    """The qwen3-1.7b smoke model, RTN-quantized in the port, with the
    kernel wrappers on (their plain versions on the CPU)."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models.modules import QSpec
    cfg = tc.get_smoke_config("qwen3-1.7b", remat=remat)
    params = tt.init_params(cfg, seed=0, device="cpu")
    qp, qcfg, _ = quantize_model(
        params, cfg, [], recipe=QuantRecipe.single(
            "rtn", QSpec(bits=4, group_size=16, rank=8)))
    qcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    return qp, qcfg


@pytest.mark.parametrize("remat,times", [("none", 1), ("full", 2),
                                         ("tp_out", 2), ("dots", 1)])
def test_remat_recomputes_the_fused_op(monkeypatch, remat, times):
    """The fused op's calls in one training step, 7 linears x layers in
    the forward: ``"full"`` and ``"tp_out"`` run each again in the
    backward's recompute, ``"dots"`` keeps its output (the custom op's)
    and runs none again; the loss and LoRA gradients are the same bits."""
    from repro_torch.kernels import ref
    calls = []
    real = ref.dequant_matmul_lora_ref
    monkeypatch.setattr(ref, "dequant_matmul_lora_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    qp, qcfg = _quantized_smoke(remat)
    flat = tpaths(qp)
    lora = sorted(p for p in flat if p.endswith(("lora_a", "lora_b")))
    live = {p: flat[p].clone().requires_grad_(True) for p in lora}
    tree: dict = {}
    for p, v in flat.items():
        set_path(tree, p, live.get(p, v))
    b = TTS(TDC(vocab=qcfg.vocab, seq_len=32, global_batch=4,
                seed=1)).next_batch()
    loss, _ = tt.loss_fn(tree, qcfg, b)
    n_fwd = len(calls)
    grads = torch.autograd.grad(loss, list(live.values()))
    assert n_fwd == 7 * qcfg.n_layers
    assert len(calls) == times * n_fwd
    base, base_cfg = qp, dataclasses.replace(qcfg, remat="none")
    tree0: dict = {}
    live0 = {p: flat[p].clone().requires_grad_(True) for p in lora}
    for p, v in tpaths(base).items():
        set_path(tree0, p, live0.get(p, v))
    loss0, _ = tt.loss_fn(tree0, base_cfg, b)
    assert loss.item() == loss0.item()
    for g, g0 in zip(grads, torch.autograd.grad(loss0, list(live0.values()))):
        assert torch.equal(g, g0)


def test_calibration_grams_equal_under_remat():
    """``run_calibration`` captures the same Grams with ``remat="full"``
    as with ``"none"``: nothing is checkpointed while Grams are captured,
    so no activation is recorded twice."""
    from repro_torch.core.pipeline import run_calibration
    cfg = tc.get_smoke_config("qwen3-1.7b", scan_layers=False)
    params = tt.init_params(cfg, seed=0, device="cpu")
    calib = [TTS(TDC(vocab=cfg.vocab, seq_len=16, global_batch=2,
                     seed=2)).next_batch()]
    full = run_calibration(params, dataclasses.replace(cfg, remat="full"),
                           calib)
    none = run_calibration(params, dataclasses.replace(cfg, remat="none"),
                           calib)
    assert full.paths() == none.paths() and full.paths()
    for p in full.paths():
        assert torch.equal(full.gram(p), none.gram(p)), p
        assert full.counts[p] == none.counts[p], p


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_drop_records_once_a_forward(remat):
    """A training step of the MoE smoke model under ``record_drops``: one
    record a layer (the forward's), none from the recompute in the
    backward, with the forward's counts."""
    cfg = tc.get_smoke_config("olmoe-1b-7b", remat=remat)
    params = tt.init_params(cfg, seed=0, device="cpu")
    flat = tpaths(params)
    live = {k: v.clone().requires_grad_(True) for k, v in flat.items()
            if v.is_floating_point()}
    tree: dict = {}
    for k, v in flat.items():
        set_path(tree, k, live.get(k, v))
    b = TTS(TDC(vocab=cfg.vocab, seq_len=16, global_batch=2,
                seed=4)).next_batch()
    with tmoe.record_drops() as log:
        loss, _ = tt.loss_fn(tree, cfg, b)
        fwd = [(int(d), int(n)) for d, n in log]
        torch.autograd.grad(loss, list(live.values()))
    assert len(fwd) == cfg.n_layers
    assert [(int(d), int(n)) for d, n in log] == fwd
