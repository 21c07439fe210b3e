"""Port parity: the LoRA fine-tuning path (``repro_torch.optim``,
``models.transformer.loss_fn``, ``launch.steps.make_train_step`` and the
``launch.train`` CLI) against ``repro.optim`` / ``repro.launch.steps``.

Tolerances and their reasons:
  * schedules: rtol 1e-6 (the same f32 formulas);
  * clipping and AdamW on the same numpy trees: rtol 1e-6 / atol 1e-7 on
    f32 leaves (same f32 arithmetic, other order of the global-norm sum),
    one bf16 ulp on bf16 leaves (the f32 result is cast back);
  * loss_fn: rtol 1e-5 (f32 forward, matmuls summed in another order);
  * three LoRA-only train steps from the same JAX-quantized smoke model
    under an f32 config: per-step loss and gradient norm within rtol 1e-4.
    The updated adapters are held only loosely (atol 2 * lr per step):
    AdamW's first steps move each weight by about lr * sign(g), so where
    |g| is at noise level a sign can differ between the two frameworks;
  * microbatch 2 against 1, fused against unfused LoRA in the port: 1e-5
    (the same f32 sums, split or ordered differently).
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.core.health import HealthPolicy
from repro.core.recipe import QuantRecipe
from repro.data import DataConfig, TokenStream
from repro.launch import steps as jsteps
from repro.models import modules as jmod
from repro.models import transformer as jt
from repro.models.parallel import LOCAL
from repro.optim import adamw as jadam
from repro.optim import schedules as jsched
from repro_torch import optim as topt
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import TokenStream as TTokenStream
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as tt
from repro_torch.utils import tree_paths as tpaths
from tests.torch_parity import configs, port_params, to_np

RNG = np.random.default_rng(0)
QSPEC = dict(bits=4, group_size=16, rank=8)


@pytest.mark.parametrize("kind", ["const", "linear", "cosine", "wsd"])
def test_schedules_match_jax(kind):
    sj = jsched.make_schedule(kind, 1e-3, 100, warmup_frac=0.1)
    st = topt.make_schedule(kind, 1e-3, 100, warmup_frac=0.1)
    for step in (0, 1, 5, 10, 50, 89, 95, 99, 100, 130):
        lt = st(torch.tensor(step, dtype=torch.int32))
        assert lt.dtype == torch.float32 and lt.dim() == 0
        np.testing.assert_allclose(float(lt), float(sj(step)), rtol=1e-6)
    with pytest.raises(ValueError):
        topt.make_schedule("bogus", 1e-3, 10)


def _tree():
    """A numpy param tree with every kind of leaf the masks see."""
    f = lambda *s: RNG.normal(size=s).astype(np.float32)      # noqa: E731
    return {"embed": {"w": f(16, 8)},
            "final_norm": {"scale": f(8)},
            "blocks": {"ln1": {"scale": f(2, 8), "bias": f(2, 8)},
                       "attn": {"q": {"qcodes": np.zeros((2, 4, 8), np.uint8),
                                      "scales": f(2, 1, 8),
                                      "zeros": f(2, 1, 8),
                                      "lora_a": f(2, 8, 2),
                                      "lora_b": f(2, 8, 2)},
                                "o": {"w": f(2, 8, 8),
                                      "lora_a": np.zeros((2, 8, 0),
                                                         np.float32),
                                      "lora_b": np.zeros((2, 8, 0),
                                                         np.float32)}}}}


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("mode", ["lora", "lora+norm", "all"])
def test_mask_partition_merge_match_jax(mode):
    tree = _tree()
    mj = jsteps.full_trainable_mask(_jt(tree), mode)
    mt = tsteps.full_trainable_mask(_tt(tree), mode)
    assert tpaths(mt) == {p: bool(v) for p, v in tpaths(mj).items()}
    trj, frj = jadam.partition_params(_jt(tree), mj)
    trt, frt = topt.partition_params(_tt(tree), mt)
    for pj, pt in ((trj, trt), (frj, frt)):
        shapes_j = {p: tuple(v.shape) for p, v in tpaths(pj).items()}
        assert {p: tuple(v.shape) for p, v in tpaths(pt).items()} == shapes_j
    merged = tpaths(topt.merge_params(trt, frt))
    for path, leaf in tpaths(tree).items():
        # a genuine rank-0 (m, 0) adapter wins over the (0,) placeholder
        assert tuple(merged[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(merged[path].numpy(), leaf)


def _opt_trees():
    f = lambda *s: RNG.normal(size=s).astype(np.float32)      # noqa: E731
    params = {"a": {"lora_a": f(6, 3), "lora_b": f(5, 3)},
              "b": {"lora_a": f(4, 2).astype(ml_dtypes.bfloat16)},
              "empty": np.zeros((0,), np.float32)}
    grads = [{"a": {"lora_a": f(6, 3), "lora_b": f(5, 3) * 0.1},
              "b": {"lora_a": f(4, 2).astype(ml_dtypes.bfloat16)},
              "empty": np.zeros((0,), np.float32)} for _ in range(2)]
    return params, grads


def _bf16(tree):
    """torch tree whose ml_dtypes bf16 leaves become torch.bfloat16."""
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_and_adamw_match_jax(max_norm):
    params, grads = _opt_trees()
    ocfg_j = jadam.OptConfig(lr=1e-2, clip_norm=max_norm, total_steps=10)
    ocfg_t = topt.OptConfig(lr=1e-2, clip_norm=max_norm, total_steps=10)
    sj = jsched.make_schedule("cosine", 1e-2, 10)
    st = topt.make_schedule("cosine", 1e-2, 10)
    pj, pt = _jt(params), _bf16(params)
    oj, ot = jadam.adamw_init(pj), topt.adamw_init(pt)
    assert ot["mu"]["b"]["lora_a"].dtype == torch.float32
    for g in grads:
        cj, nj = jadam.clip_by_global_norm(_jt(g), max_norm)
        ct, nt = topt.clip_by_global_norm(_bf16(g), max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        pj, oj, mj = jadam.adamw_update(_jt(g), oj, pj, ocfg_j, sj)
        pt, ot, mt = topt.adamw_update(_bf16(g), ot, pt, ocfg_t, st)
        assert int(ot["step"]) == int(oj["step"])
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        for name, tj, tt_ in (("clip", cj, ct), ("params", pj, pt),
                              ("mu", oj["mu"], ot["mu"]),
                              ("nu", oj["nu"], ot["nu"])):
            lj, lt = tpaths(jax.device_get(tj)), tpaths(tt_)
            assert sorted(lj) == sorted(lt), name
            for path in lj:
                bf16 = str(lj[path].dtype) == "bfloat16"
                assert lt[path].dtype == (torch.bfloat16 if bf16
                                          else torch.float32), (name, path)
                np.testing.assert_allclose(
                    to_np(lt[path]), to_np(lj[path]),
                    rtol=2 ** -7 if bf16 else 1e-6, atol=1e-7,
                    err_msg=f"{name} {path}")


def _batch(vocab, seq, batch, seed):
    """The JAX package's token stream."""
    return TokenStream(DataConfig(vocab=vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))


def _tbatch(vocab, seq, batch, seed):
    """The port's token stream (byte-identical batches)."""
    return TTokenStream(TDataConfig(vocab=vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))


@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_fn_matches_jax(chunk):
    cfg_j, cfg_t = configs(loss_chunk=chunk)
    pj = jt.init_params(jax.random.PRNGKey(1), cfg_j)
    pt = port_params(pj, cfg_t)
    b = {k: np.array(v)
         for k, v in _batch(cfg_j.vocab, 32, 3, 1).next_batch().items()}
    b["labels"] = np.where(RNG.random(b["labels"].shape) < 0.2, -1,
                           b["labels"]).astype(np.int32)
    lj, (cej, _) = jt.loss_fn(pj, cfg_j, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    lt, (cet, aux) = tt.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(cet), float(cej), rtol=1e-5)


def test_loss_chunk_matches_unchunked():
    _, cfg_t = configs()
    pt = tt.init_params(cfg_t, seed=0, device="cpu")
    b = _tbatch(cfg_t.vocab, 32, 2, 0).next_batch()
    full, _ = tt.loss_fn(pt, cfg_t, b)
    chunked, _ = tt.loss_fn(pt, dataclasses.replace(cfg_t, loss_chunk=8), b)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


@pytest.fixture(scope="module")
def quantized():
    """The smoke model quantized once by JAX (f32 config), carried into the
    port: (JAX params, JAX cfg, port params, port cfg)."""
    cfg_j, cfg_t = configs()
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    calib = [_batch(cfg_j.vocab, 32, 2, 5).next_batch()]
    qj, cfg_j, _ = jp.quantize_model(
        pj, cfg_j, calib,
        recipe=QuantRecipe.single("cloq", jmod.QSpec(**QSPEC)),
        engine="sequential", policy=HealthPolicy(enabled=False))
    cfg_t = dataclasses.replace(cfg_t, quant=tmod.QSpec(**QSPEC))
    return qj, cfg_j, port_params(qj, cfg_t), cfg_t


def _port_steps(params, cfg, ocfg, n, seed=3):
    state = tsteps.build_state(params, ocfg)
    step = tsteps.make_train_step(cfg, ocfg)
    stream = _tbatch(cfg.vocab, 32, 4, seed)
    out = []
    for _ in range(n):
        state, m = step(state, stream.next_batch())
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def test_lora_train_steps_match_jax(quantized):
    qj, cfg_j, qt, cfg_t = quantized
    lr = 1e-3
    ocfg_j = jadam.OptConfig(lr=lr, trainable="lora", total_steps=3,
                             schedule="const")
    ocfg_t = topt.OptConfig(lr=lr, trainable="lora", total_steps=3,
                            schedule="const")
    sj = jsteps.build_state(qj, ocfg_j)
    step_j = jax.jit(jsteps.make_train_step(cfg_j, ocfg_j, LOCAL))
    stream = _batch(cfg_j.vocab, 32, 4, 3)
    mj = []
    for _ in range(3):
        sj, m = step_j(sj, stream.next_batch())
        mj.append({k: float(v) for k, v in m.items()})
    st, mt = _port_steps(qt, cfg_t, ocfg_t, 3)
    for i, (a, b) in enumerate(zip(mt, mj)):
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    lj = tpaths(jax.device_get(sj["train"]))
    lt = tpaths(st["train"])
    n_lora = 0
    for path, leaf in lj.items():
        if "lora" not in path:
            continue
        n_lora += 1
        np.testing.assert_allclose(to_np(lt[path]), np.asarray(leaf),
                                   atol=2 * lr * 3, err_msg=path)
    assert n_lora == 14
    # only the adapters moved: the frozen tree is the quantized base
    for path, leaf in tpaths(st["frozen"]).items():
        if leaf.numel():
            assert torch.equal(leaf, tpaths(qt)[path]), path


def test_microbatch_two_matches_one(quantized):
    _, _, qt, cfg_t = quantized
    runs = []
    for k in (1, 2):
        ocfg = topt.OptConfig(lr=1e-3, total_steps=2, microbatch=k)
        runs.append(_port_steps(qt, cfg_t, ocfg, 2))
    (s1, m1), (s2, m2) = runs
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-5)
    for path, leaf in tpaths(s1["train"]).items():
        np.testing.assert_allclose(to_np(tpaths(s2["train"])[path]),
                                   to_np(leaf), rtol=1e-5, atol=1e-6)


def test_fused_lora_matches_unfused(quantized, monkeypatch):
    """The kernel path (fused, as a training batch's 128 rows take it) and
    the plain unfused path give the same trajectory."""
    _, _, qt, cfg_t = quantized
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "FUSED_LORA_MIN_ROWS", 128)
    runs = []
    for fused in (False, True):
        cfg = dataclasses.replace(cfg_t, quant=dataclasses.replace(
            cfg_t.quant, use_kernel=fused))
        runs.append(_port_steps(qt, cfg, topt.OptConfig(lr=1e-3,
                                                        total_steps=3), 3))
    (su, mu), (sf, mf) = runs
    for a, b in zip(mu, mf):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-5)
    for path, leaf in tpaths(su["train"]).items():
        np.testing.assert_allclose(to_np(tpaths(sf["train"])[path]),
                                   to_np(leaf), rtol=1e-5, atol=1e-6)


def test_fused_lora_routes_through_the_fused_wrapper(quantized, monkeypatch):
    _, _, qt, cfg_t = quantized
    from repro_torch.kernels import ops
    calls = []
    real = ops.dequant_matmul_lora

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "dequant_matmul_lora", spy)
    cfg = dataclasses.replace(cfg_t, quant=dataclasses.replace(
        cfg_t.quant, use_kernel=True))
    b = _tbatch(cfg.vocab, 16, 2, 0).next_batch()      # 32 rows of x
    monkeypatch.setattr(ops, "FUSED_LORA_MIN_ROWS", 32)
    tt.loss_fn(qt, cfg, b)
    assert len(calls) == 7 * cfg.n_layers
    assert all(s[:-1].numel() == 32 for s in calls)
    calls.clear()
    monkeypatch.setattr(ops, "FUSED_LORA_MIN_ROWS", 33)
    tt.loss_fn(qt, cfg, b)
    assert not calls
    monkeypatch.setattr(ops, "FUSED_LORA_MIN_ROWS", 32)
    tt.loss_fn(qt, dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, use_kernel=False)), b)
    assert not calls


def test_train_cli_on_cpu(capsys):
    rc = ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq-len", "16",
                      "--calib-batches", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[quantize] rules=0 default=cloq/4b" in out
    assert "[step] i=1 " in out and '[done] {"final_loss": ' in out


def test_train_cli_full_finetune_without_quantization():
    args = ttrain.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--method",
         "none", "--steps", "2", "--batch", "2", "--seq-len", "16",
         "--pretrain-steps", "1"])
    res = ttrain.run(args)
    assert res["quantize_s"] == 0.0 and len(res["losses"]) == 2
    assert res["cfg"].quant is None
    trained = [p for p, v in tpaths(res["state"]["train"]).items()
               if v.numel()]
    assert "embed.w" in trained and "blocks.attn.q.w" in trained


@pytest.mark.parametrize("flag", [
    ["--compile-cache", "x", "--ckpt-dir", "y"],
    ["--resume", "--cost-cal", "auto", "--compile-cache", "x"],
    ["--resume-quant", "x", "--compile-cache", "c"],
    ["--compile-cache", "x"], ["--cost-cal", "c.json", "--compile-cache", "x"],
    ["--cost-cal", "auto", "--auto-allocate", "--budget-mb", "5",
     "--compile-cache", "x"],
    ["--cost-cal", "auto", "--trace-out", "t.json", "--compile-cache", "x"],
    ["--compile-cache", "x", "--trace-out", "t.json"],
    ["--compile-cache", "x", "--cost-cal", "auto", "--metrics-out", "m"]])
def test_train_rejects_what_is_not_ported(flag, tmp_path, monkeypatch):
    """Every flag of the JAX CLI is ported: ``--compile-cache DIR`` is
    taken beside the checkpoint, journal, allocation, tracing and
    cost-model flags, and names the directory the kernel libraries are
    built into and loaded from, before the model is built."""
    from repro_torch.kernels import build
    monkeypatch.chdir(tmp_path)     # a trace, if asked for, lands here
    monkeypatch.setattr(build, "_cache", None)

    class Built(Exception):
        pass

    def init_params(*a, **kw):
        raise Built

    monkeypatch.setattr(ttrain, "init_params", init_params)
    with pytest.raises(Built):
        ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     *flag])
    want = flag[flag.index("--compile-cache") + 1]
    assert build.active_cache().directory == tmp_path / want
    assert not (tmp_path / want).exists()


def test_train_rejects_unported_methods_and_needs_cuda(monkeypatch):
    """Every method the JAX CLI offers runs (below); any other is refused
    before anything is built, and the CLI needs CUDA unless the CPU is
    asked for."""
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     "--method", "apiq", "--steps", "1"])
    assert ttrain.build_parser().parse_args(
        ["--arch", "a"]).method == "cloq"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "qwen3-1.7b", "--smoke"])


TRAIN_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--steps", "2", "--batch", "2", "--seq-len", "16",
               "--calib-batches", "1"]


@pytest.mark.parametrize("method", ["cloq", "gptq", "loftq", "qlora", "rtn"])
def test_train_cli_each_method(method, capsys):
    """``python -m repro_torch.launch.train --method M`` quantizes through
    the batched engine with the health guards on (their summary printed)
    and fine-tunes with finite losses; gptq, qlora and rtn start from
    ``B == 0``, qlora stores NF4 codes."""
    from repro_torch.core import pipeline
    seen = {}
    real = pipeline.quantize_model

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen["tree"] = tpaths(out[0])
        seen["engine"] = kw.get("engine", "batched")
        return out

    ttrain.quantize_model, keep = spy, ttrain.quantize_model
    try:
        rc = ttrain.main(TRAIN_SMOKE + ["--method", method])
    finally:
        ttrain.quantize_model = keep
    assert rc == 0
    out = capsys.readouterr().out
    assert f"default={method}/4b" in out and '[done] {"final_loss": ' in out
    assert "[quantize] health: 14 slices checked, all clean" in out
    assert seen["engine"] == "batched"
    tree = seen["tree"]
    b = [v for p, v in tree.items() if p.endswith("lora_b")]
    assert len(b) == 7
    assert all(not v.any() for v in b) == (method != "cloq" and
                                           method != "loftq")
    assert any(p.endswith("absmax") for p in tree) == (method == "qlora")


def test_train_cli_resume_quant(tmp_path, monkeypatch, capsys):
    """SIGTERM during quantization with ``--resume-quant``: the engine stops
    at the next bucket boundary, the CLI warns and exits 0; the rerun with
    the same directory restores the committed bucket and trains to the
    losses of a run that was never stopped."""
    jd = str(tmp_path / "q")
    argv = TRAIN_SMOKE + ["--resume-quant", jd]
    real = ttrain.quantize_model

    def stopping(*a, **kw):
        stop = kw["should_stop"]

        def should_stop():
            signal.raise_signal(signal.SIGTERM)
            return stop()
        return real(*a, **dict(kw, should_stop=should_stop))

    monkeypatch.setattr(ttrain, "quantize_model", stopping)
    assert ttrain.main(argv) == 0
    assert "[preempt-quant] signal received — buckets 0..0 committed" in \
        capsys.readouterr().out
    monkeypatch.setattr(ttrain, "quantize_model", real)
    resumed = ttrain.run(ttrain.build_parser().parse_args(argv))
    assert any("restored from journal" in e for e in
               resumed["health"].events)
    fresh = ttrain.run(ttrain.build_parser().parse_args(TRAIN_SMOKE))
    assert resumed["losses"] == fresh["losses"]
    assert resumed["grad_norms"] == fresh["grad_norms"]
    assert os.path.isfile(os.path.join(jd, "health.json"))
