"""Port parity: the Mamba2 / SSD block (``repro_torch.models.ssm``) and the
SSM family's model and CLI paths (Mamba2-370M's smoke config) against the
JAX package, on the CPU.  The Mamba layers' calibration and quantization
are held against JAX's in ``tests/test_torch_hybrid.py``, on a model that
has them beside the shared block.

The same numpy params and inputs go through ``repro`` and
``repro_torch``.  Tolerances: the SSD scan against the JAX function and
the token-by-token recurrence within atol 1e-5, and the block's decode
against its prefill within 1e-4, the reference's own
(``tests/test_models.py``); the block, the model's logits, losses, LoRA
gradients and decode within 1e-4 (atol and rtol; f32 sums in another
order), the port's rule for f32 paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.utils import tree_paths as jpaths
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.utils import set_path
from repro_torch.utils import tree_paths as tpaths
from tests.torch_parity import jax_to_numpy, port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = dict(d_model=32, d_state=8, head_dim=8, n_groups=2, chunk=4)


def _scan_inputs(rng, b, s, h, p, n):
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    """``tests/test_models.py::test_ssd_chunked_equals_recurrence``'s
    inputs: the port's chunked scan (a Python loop over chunks) against
    the token-by-token recurrence and the JAX function, outputs and final
    states within 1e-5."""
    rng = np.random.default_rng(0)
    x, dt, A, B, C = _scan_inputs(rng, 2, 16, 3, 4, 5)
    st = np.zeros((2, 3, 4, 5), np.float32)
    ys = []
    for t in range(16):
        decay = np.exp(dt[:, t] * A[None, :])
        st = st * decay[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", C[:, t], st))
    y_rec = np.stack(ys, axis=1)
    y, fin = tssm.ssd_chunked(*_t(x, dt, A, B, C), chunk)
    yj, finj = jssm.ssd_chunked(*_j(x, dt, A, B, C), chunk)
    for got, want in ((y, y_rec), (fin, st), (y, np.asarray(yj)),
                      (fin, np.asarray(finj))):
        np.testing.assert_allclose(to_np(got), want, atol=1e-5)


def test_ssd_init_state_continuation_matches_jax():
    """A sequence split over two scans, the second starting from the
    first's final state, equals one scan; the second scan equals the JAX
    function given the same ``init_state``."""
    rng = np.random.default_rng(1)
    x, dt, A, B, C = _t(*_scan_inputs(rng, 1, 16, 2, 4, 3))
    y_full, st_full = tssm.ssd_chunked(x, dt, A, B, C, 4)
    y1, st1 = tssm.ssd_chunked(x[:, :8], dt[:, :8], A, B[:, :8], C[:, :8], 4)
    y2, st2 = tssm.ssd_chunked(x[:, 8:], dt[:, 8:], A, B[:, 8:], C[:, 8:], 4,
                               init_state=st1)
    np.testing.assert_allclose(to_np(torch.cat([y1, y2], 1)), to_np(y_full),
                               atol=1e-5)
    np.testing.assert_allclose(to_np(st2), to_np(st_full), atol=1e-5)
    yj, stj = jssm.ssd_chunked(*_j(*(to_np(t[:, 8:]) for t in (x, dt)),
                                   to_np(A),
                                   *(to_np(t[:, 8:]) for t in (B, C))),
                               4, init_state=jnp.asarray(to_np(st1)))
    np.testing.assert_allclose(to_np(y2), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(to_np(st2), np.asarray(stj), atol=1e-5)


@pytest.fixture(scope="module")
def block():
    """The reference's block (``SSMConfig(32, 8, 8, n_groups=2, chunk=4)``)
    with non-zero conv biases, ``d`` and ``dt_bias``, the same params on
    both sides."""
    cfg_j, cfg_t = jssm.SSMConfig(**BLOCK), tssm.SSMConfig(**BLOCK)
    pn = jax_to_numpy(jssm.mamba_init(jax.random.PRNGKey(1), cfg_j,
                                      dtype=jnp.float32))
    rng = np.random.default_rng(2)
    for k in ("conv_x_b", "conv_bc_b", "d", "dt_bias"):
        pn[k] = (rng.normal(size=pn[k].shape) * 0.3).astype(np.float32)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pn)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn), pt


def test_causal_conv_matches_jax(block):
    _, _, pj, pt = block
    x = np.random.default_rng(3).normal(size=(2, 7, 64)).astype(np.float32)
    got = tssm._causal_conv(torch.from_numpy(x), pt["conv_x"],
                            pt["conv_x_b"])
    want = jssm._causal_conv(jnp.asarray(x), pj["conv_x"], pj["conv_x_b"])
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def test_split_heads_reads_each_heads_group():
    """With 2 groups of 8 heads, head h reads group h // 4
    (``repeat_interleave``, as ``jnp.repeat``), not group h % 2."""
    cfg = tssm.SSMConfig(d_model=32, d_state=3, head_dim=8, n_groups=2)
    bc = torch.arange(2 * 2 * 3, dtype=torch.float32)[None]
    _, Bm, Cm = tssm._split_heads(cfg, torch.zeros(1, 64), bc, (1,))
    _, Bj, Cj = jssm._split_heads(jssm.SSMConfig(32, 3, 8, n_groups=2),
                                  jnp.zeros((1, 64)), jnp.asarray(to_np(bc)),
                                  (1,))
    np.testing.assert_array_equal(to_np(Bm), np.asarray(Bj))
    np.testing.assert_array_equal(to_np(Cm), np.asarray(Cj))
    assert Bm[0, 3, 0] == 0 and Bm[0, 4, 0] == 3


def test_mamba_apply_and_decode_match_jax(block):
    """The block's prefill against the JAX block within 1e-4, its decode
    step by step against the JAX decode and against its own prefill
    (1e-4, ``tests/test_models.py::test_mamba_decode_matches_prefill``)."""
    cfg_j, cfg_t, pj, pt = block
    x = np.random.default_rng(4).normal(size=(2, 8, 32)).astype(np.float32)
    y_full = tssm.mamba_apply(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(
        to_np(y_full), np.asarray(jssm.mamba_apply(pj, cfg_j,
                                                   jnp.asarray(x))), **TOL)
    ct, cj = tssm.mamba_init_cache(cfg_t, 2), jssm.mamba_init_cache(cfg_j, 2)
    step = jax.jit(lambda p, x, c: jssm.mamba_decode(p, cfg_j, x, c))
    outs = []
    for t in range(8):
        o, ct = tssm.mamba_decode(pt, cfg_t, torch.from_numpy(x[:, t:t + 1]),
                                  ct)
        oj, cj = step(pj, jnp.asarray(x[:, t:t + 1]), cj)
        np.testing.assert_allclose(to_np(o), np.asarray(oj), **TOL)
        for k in ("conv_x", "conv_bc", "state"):
            np.testing.assert_allclose(to_np(ct[k]), np.asarray(cj[k]),
                                       err_msg=k, **TOL)
        outs.append(o[:, 0])
    np.testing.assert_allclose(to_np(torch.stack(outs, 1)), to_np(y_full),
                               atol=1e-4)


def test_mamba_decode_writes_the_cache_in_place(block):
    """The step writes its conv windows and state into the tensors it was
    given (a captured step reads fixed addresses, and the fixed-slot loop
    drops the returned cache): same storage, new values, the same dict
    returned."""
    _, cfg_t, _, pt = block
    cache = tssm.mamba_init_cache(cfg_t, 2)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 1, 32)).astype(np.float32))
    _, out = tssm.mamba_decode(pt, cfg_t, x, cache)
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert all(bool(v.abs().sum() > 0) for v in cache.values())
    # the newest conv row is the input's projection's; the rest shifted
    before = cache["conv_x"].clone()
    tssm.mamba_decode(pt, cfg_t, x, cache)
    assert torch.equal(cache["conv_x"][:, :-1], before[:, 1:])


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module", params=[True, False], ids=["scan", "eager"])
def smoke(request):
    """Mamba2-370M's smoke model with LoRA rank 4 on every linear (``lora_b``
    drawn, so every adapter gets a gradient), non-zero ``dt_bias``, in the
    scan-stacked or eager layout on both sides."""
    from repro import configs as jc
    from repro_torch import configs as tc
    kw = dict(lora_rank=4, scan_layers=request.param)
    cfg_j = jc.get_smoke_config("mamba2-370m", **kw)
    cfg_t = tc.get_smoke_config("mamba2-370m", **kw)
    pn = jax_to_numpy(jt.init_params(jax.random.PRNGKey(5), cfg_j))
    rng = np.random.default_rng(6)
    for path, leaf in jpaths(pn).items():
        if path.endswith(("lora_b", "dt_bias")):
            node = pn
            for k in path.split(".")[:-1]:
                node = node[k]
            node[path.rsplit(".", 1)[1]] = (
                rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn), port_params(pn, cfg_t)


def _batches(rng, vocab, shape):
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


def _lora_grads_match(cfg_j, cfg_t, pj, pt, batch_j, batch_t,
                      must: str) -> None:
    """``loss_fn`` and the gradient of every LoRA leaf against JAX's."""
    gj = jpaths(jax.grad(lambda p: jt.loss_fn(p, cfg_j, batch_j)[0])(pj))
    flat = tpaths(pt)
    lora = sorted(p for p in flat if p.endswith(("lora_a", "lora_b")))
    assert any(must in p for p in lora)
    leaves = [flat[p].clone().requires_grad_(True) for p in lora]
    live = dict(flat)
    live.update(zip(lora, leaves))
    tree: dict = {}
    for p, v in live.items():
        set_path(tree, p, v)
    loss_t, _ = tt.loss_fn(tree, cfg_t, batch_t)
    np.testing.assert_allclose(loss_t.item(),
                               float(jt.loss_fn(pj, cfg_j, batch_j)[0]),
                               **TOL)
    for p, g in zip(lora, torch.autograd.grad(loss_t, leaves)):
        np.testing.assert_allclose(to_np(g), np.asarray(gj[p]), err_msg=p,
                                   **TOL)


def test_forward_loss_and_lora_grads_match_jax(smoke):
    """Logits over 16 tokens (two 8-token chunks: the scan carries a state
    between them) and ``loss_fn``; every LoRA gradient in the scan layout
    (the training layout)."""
    cfg_j, cfg_t, pj, pt = smoke
    batch_j, batch_t = _batches(np.random.default_rng(7), cfg_j.vocab,
                                (2, 16))
    lj, _ = jt.forward(pj, cfg_j, batch_j)
    lt, aux = tt.forward(pt, cfg_t, batch_t)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    assert float(aux) == 0.0
    if cfg_t.scan_layers:
        _lora_grads_match(cfg_j, cfg_t, pj, pt, batch_j, batch_t, "dt_proj")
    else:
        np.testing.assert_allclose(
            tt.loss_fn(pt, cfg_t, batch_t)[0].item(),
            float(jt.loss_fn(pj, cfg_j, batch_j)[0]), **TOL)


def test_decode_steps_match_jax(smoke):
    """Six greedy decode steps at batch 3 from the same caches; the
    port's cache tensors are written in place."""
    cfg_j, cfg_t, pj, pt = smoke
    cj = jt.init_decode_cache(cfg_j, 3, 8)
    ct = tt.init_decode_cache(cfg_t, 3, 8, device="cpu")
    assert sorted(ct) == sorted(cj)
    state = ct["state"]
    tok = np.array([[3], [17], [101]], np.int32)
    tj, tk = jnp.asarray(tok), torch.from_numpy(tok)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, cfg_j, c, t))
    for _ in range(6):
        lj, cj = step(pj, cj, tj)
        lt, ct = tt.decode_step(pt, cfg_t, ct, tk)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
        np.testing.assert_allclose(to_np(ct["state"]), np.asarray(cj["state"]),
                                   **TOL)
        tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tk = lt.argmax(-1, keepdim=True)
        assert np.array_equal(np.asarray(tj), to_np(tk))
    assert ct["state"] is state and int(ct["idx"]) == 6


def test_train_and_serve_clis_run_mamba2(capsys):
    """``repro_torch.launch.train --arch mamba2-370m --smoke --device cpu``
    (every Mamba linear quantized and checked clean, finite losses) and
    ``repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu``
    (the fixed-slot loop serves every request)."""
    from repro_torch.launch import serve, train
    assert train.main(["--arch", "mamba2-370m", "--smoke", "--device",
                       "cpu", "--steps", "2", "--seq-len", "32",
                       "--batch", "2", "--calib-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "health: 15 slices checked, all clean" in out, out
    assert "[done]" in out
    res = serve.run(serve.build_parser().parse_args(
        ["--arch", "mamba2-370m", "--smoke", "--device", "cpu"]))
    s = res["serve"]
    assert res["route"] == "fixed_slots" and res["cfg"].family == "ssm"
    assert s["requests_done"] == 8 and s["all_finite"]
