"""Port parity: the SSM (Mamba2), hybrid (Zamba2), enc-dec (Seamless) and
vision-prefix (Pixtral) families' sharded fine-tuning step and decode on a
``(data 2, model 2)`` ``torch.distributed`` mesh against the JAX package's
unsharded ones, and a bf16 sharded step through gloo.

The port's ranks (4 gloo processes on the CPU, bodies in
``tests/torch_sharded_families_worker.py``) run once for the whole file.
As in ``tests/test_torch_sharded_train.py``, the oracle is JAX's
*unsharded* ``make_train_step(..., LOCAL)`` and ``decode_step``: GSPMD
computes the same model from ``src/repro/launch/shardings.py``'s layouts.

The f32 smoke configs: Mamba2 (3 layers, 8 heads of 16: 4 a rank), a
Mamba2 whose one head of 128 the model axis splits (``z``/``x`` gathered,
every head on every rank), Zamba2 (6 layers, two shared-block sites, 2
groups: each rank's heads read one), Seamless (2 + 2 layers, its decode
over an encoder output: JAX's encoder in the reference, the port's
sharded one in the ranks, over the same frames) and Pixtral (2 layers, 8
prefix positions), each ``trainable="all"`` (``a_log``, ``d``,
``dt_bias``, the conv weights, every norm scale) with and without
``seq_shard``; Zamba2 CLoQ-quantized by the port's engine and trained
``"lora"``, so that its per-site adapter stacks are sharded.  Tolerances (f32), as that file's and for the same reasons:
  * each step's loss: rtol 2e-4;
  * step 1's gradient norm: rtol 1e-4; every trainable leaf's gradient
    within 1e-3 relative + 1e-4 of its largest entry (a missing sum over
    "model" is off by about half a gradient);
  * the trainable leaves after step 1: atol 2 * lr;
  * the decode's logits, fed JAX's greedy tokens: atol 1e-4.

The bf16 case: the qwen3 smoke model CLoQ-quantized in bf16 by the
port's engine, ``"lora"``, with and without ``seq_shard`` (its activations and
the gathered gradients are bf16 all-gathers through gloo), held to
``chip_smoke.py``'s ``train_sharded`` bounds: losses within
``LOSS_LIMIT`` (1e-2), step 1's gradient norm within ``SHARDED_NORM_REL``
(1e-2), each LoRA gradient within ``SHARDED_GRAD_REL`` (8 * 2^-8,
relative Frobenius) and the leaves within 2 * lr + one bf16 ulp of the
largest (XLA and torch sum bf16 products in other orders).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.launch import steps as jsteps
from repro.models import modules as jmod
from repro.models.attention import attn_apply as jattn_apply
from repro.models.mlp import swiglu_apply as jswiglu_apply
from repro.models import transformer as jt
from repro.models.parallel import LOCAL
from repro.optim import OptConfig as JOptConfig
from repro.optim import merge_params as jmerge
from repro_torch import configs as tc
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe as TQuantRecipe
from repro_torch.data import DataConfig, TokenStream
from repro_torch.data.pipeline import data_kind
from repro_torch.launch import mesh as tmesh
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as tt
from repro_torch.optim import OptConfig
from repro_torch.utils import tree_paths as tpaths
from tests import torch_sharded_families_worker
from tests.torch_parity import port_params, worker_threads
from tests.util import SRC

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
QSPEC = dict(bits=4, group_size=16, rank=8)
SEQ, ENC = 16, 16                # tokens a row; the encoder's frames
# name -> (arch, config overrides)
FAMILIES = {"mamba": ("mamba2-370m", {}),
            "mamba_split": ("mamba2-370m", {"ssm_head_dim": 128}),
            "zamba": ("zamba2-7b", {}),
            "seamless": ("seamless-m4t-medium", {}),
            "pixtral": ("pixtral-12b", {})}
STEPS = ["mamba", "mamba_seq", "mamba_split", "zamba", "zamba_seq",
         "zamba_lora", "zamba_lora_seq", "seamless", "seamless_seq",
         "pixtral", "pixtral_seq"]
DECODES = ["mamba", "mamba_split", "zamba", "zamba_lora", "seamless",
           "pixtral"]
# the structure chip_smoke.predicted_collectives counts, one "lora" step
COUNTED = ("mamba", "zamba", "seamless", "pixtral")


def _cfgs(arch: str, **kw):
    return (jc.get_smoke_config(arch, **kw),
            tc.get_smoke_config(arch, **kw))


def _batches(cfg, n: int = 3) -> list:
    ds = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                global_batch=4, seed=2, kind=data_kind(cfg),
                                enc_len=ENC, n_prefix=cfg.n_prefix,
                                d_model=cfg.d_model))
    return [ds.next_batch() for _ in range(n)]


def _jb(b: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _jax_ref(cfg, ocfg, params, batches) -> dict:
    """JAX's unsharded step: step 1's gradients, each step's metrics, the
    trainable leaves after step 1."""
    st = jsteps.build_state(params, ocfg)

    def loss_of(tp, b):
        return jt.loss_fn(jmerge(tp, st["frozen"]), cfg, b, pctx=LOCAL)
    (_, _), g = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        st["train"], _jb(batches[0]))
    f = jax.jit(jsteps.make_train_step(cfg, ocfg, LOCAL))
    out = {"grads": {k: np.asarray(v, np.float32)
                     for k, v in tpaths(g).items()}, "metrics": []}
    for i, b in enumerate(batches):
        st, m = f(st, _jb(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["leaves"] = {k: np.asarray(v, np.float32)
                             for k, v in tpaths(st["train"]).items()}
    return out


def _jax_encode(cfg, params, emb: np.ndarray) -> np.ndarray:
    """The JAX package's encoder over ``emb`` (``_forward_encdec``'s
    encoder layers and norm, which have no entry point of their own):
    what an enc-dec decode cache's ``enc_out`` holds."""
    x = jnp.asarray(emb).astype(cfg.dtype)
    blocks = params["enc_blocks"]
    for i in range(cfg.n_enc_layers):
        bp = (jax.tree.map(lambda a: a[i], blocks) if cfg.scan_layers
              else blocks[str(i)])
        x = x + jattn_apply(bp["attn"], cfg.attn_cfg(causal=False),
                            jmod.rmsnorm_apply(bp["ln1"], x),
                            qspec=cfg.quant)
        x = x + jswiglu_apply(bp["mlp"], jmod.rmsnorm_apply(bp["ln2"], x),
                              cfg.quant)
    return np.asarray(jmod.rmsnorm_apply(params["enc_norm"], x), np.float32)


def _jax_decode(cfg, params, enc_out=None, n: int = 3) -> dict:
    """JAX's greedy decode from tokens (3, 5, 7, 11), batch 4, cache 16:
    the tokens fed each step and its logits."""
    cache = jt.init_decode_cache(cfg, 4, 16)
    if enc_out is not None:
        cache["enc_out"] = jnp.asarray(enc_out)
    tok = jnp.asarray([[3], [5], [7], [11]], jnp.int32)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, cfg, c, t))
    fed, logits = [], []
    for _ in range(n):
        fed.append(torch.from_numpy(np.array(tok)))
        lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    return {"tokens": fed, "logits": logits}


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _quantized(cj, ct, batches):
    """``(JAX params, JAX config, port params, port config)`` of a model
    (JAX's init) CLoQ-quantized by the port's batched engine over
    ``batches`` (the same tree in both packages: the steps are what is
    compared, on the same quantized model)."""
    pt = port_params(jt.init_params(jax.random.PRNGKey(0), cj), ct)
    qt, ct, _ = quantize_model(
        pt, ct, batches,
        recipe=TQuantRecipe.single("cloq", tmod.QSpec(**QSPEC)))
    qj = jax.tree.map(_to_jax, qt)
    return qj, dataclasses.replace(cj, quant=jmod.QSpec(**QSPEC)), qt, ct


def _family_cases(work: Path) -> tuple[dict, dict]:
    """The ranks' scenarios and JAX's references."""
    inp, ref = {}, {}
    oj = JOptConfig(lr=LR, trainable="all", total_steps=5)
    ot = OptConfig(lr=LR, trainable="all", total_steps=5)
    for name, (arch, kw) in FAMILIES.items():
        cj, ct = _cfgs(arch, **kw)
        pj = jt.init_params(jax.random.PRNGKey(0), cj)
        batches = _batches(ct)
        pt = port_params(pj, ct)
        sc = {"cfg": ct, "ocfg": ot, "params": pt, "batches": batches}
        enc = None
        if ct.family == "encdec":
            emb = np.random.default_rng(11).normal(
                size=(4, ENC, ct.d_model)).astype(np.float32)
            enc = _jax_encode(cj, pj, emb)
            emb = torch.from_numpy(emb)
        if name in DECODES:
            ref[f"{name}.decode"] = _jax_decode(cj, pj, enc)
            sc["decode"] = {"tokens": ref[f"{name}.decode"]["tokens"]}
            if enc is not None:
                sc["decode"]["enc_embeds"] = emb
        inp[name] = sc
        ref[name] = _jax_ref(cj, oj, pj, batches)
        if name != "mamba_split":
            inp[f"{name}_seq"] = dict(
                sc, cfg=dataclasses.replace(ct, seq_shard=True))
            inp[f"{name}_seq"].pop("decode", None)
            ref[f"{name}_seq"] = ref[name]
    # Zamba2 quantized: its per-site LoRA stacks sharded
    cj, ct = _cfgs("zamba2-7b")
    batches = _batches(ct, 4)
    qj, qcj, qt, qct = _quantized(cj, ct, batches[3:])
    oj = JOptConfig(lr=LR, trainable="lora", total_steps=5)
    ot = OptConfig(lr=LR, trainable="lora", total_steps=5)
    ref["zamba_lora"] = ref["zamba_lora_seq"] = _jax_ref(qcj, oj, qj,
                                                         batches[:3])
    ref["zamba_lora.decode"] = _jax_decode(qcj, qj)
    inp["zamba_lora"] = {"cfg": qct, "ocfg": ot, "params": qt,
                         "batches": batches[:3],
                         "decode": {"tokens":
                                    ref["zamba_lora.decode"]["tokens"]}}
    inp["zamba_lora_seq"] = {"cfg": dataclasses.replace(qct, seq_shard=True),
                             "ocfg": ot, "params": qt,
                             "batches": batches[:3]}
    # bf16: the qwen3 smoke model quantized in bf16
    cj, ct = _cfgs("qwen3-1.7b", dtype=jnp.bfloat16)
    ct = dataclasses.replace(ct, dtype=torch.bfloat16)
    batches = _batches(ct, 4)
    qj, qcj, qt, qct = _quantized(cj, ct, batches[3:])
    ref["bf16"] = ref["bf16_seq"] = _jax_ref(qcj, oj, qj, batches[:3])
    for name, seq in (("bf16", False), ("bf16_seq", True)):
        inp[name] = {"cfg": dataclasses.replace(qct, seq_shard=seq),
                     "ocfg": ot, "params": qt, "batches": batches[:3]}
    # one "lora" step of each family's structure, for the collective count
    for fam in COUNTED:
        _, ct = _cfgs(FAMILIES[fam][0])
        batches = _batches(ct, 2)
        qp, qc, _ = quantize_model(
            tt.init_params(ct, seed=0, device="cpu"), ct, batches[1:],
            recipe=TQuantRecipe.single("rtn", tmod.QSpec(**QSPEC)))
        for seq in (False, True):
            inp[f"count.{fam}.{int(seq)}"] = {
                "cfg": dataclasses.replace(qc, seq_shard=seq), "ocfg": ot,
                "params": qp, "batches": batches[:1]}
    return inp, ref


def _spawn(work: Path, tag: str) -> dict:
    tmesh.spawn_ranks(torch_sharded_families_worker.run, 4, backend="gloo",
                      device="cpu", args=(str(work), tag),
                      threads=max(1, worker_threads() // 4),
                      store_dir=str(work))
    with open(work / f"{tag}.outputs.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax, workdir)``: the ranks' outputs, JAX's references and
    the directory holding the ranks' inputs."""
    work = tmp_path_factory.mktemp("families")
    inp, ref = _family_cases(work)
    torch.save(inp, work / "all.inputs.pt")
    return _spawn(work, "all"), ref, work


def _held(got: dict, want: dict) -> None:
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-4,
                                   err_msg=f"step {i} loss")
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                               want["metrics"][0]["grad_norm"], rtol=1e-4)
    assert got["equal_on_ranks"]
    assert sorted(got["grads"]) == sorted(want["grads"])
    for path, w in want["grads"].items():
        if not w.size:
            continue
        np.testing.assert_allclose(got["grads"][path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)
        np.testing.assert_allclose(got["leaves"][path], want["leaves"][path],
                                   atol=2 * LR, err_msg=path)


@pytest.mark.parametrize("name", STEPS)
def test_family_step_matches_jax_unsharded(runs, name):
    """3 steps of each family on the (2, 2) mesh against JAX's unsharded
    step, with and without ``seq_shard``; metrics equal on every rank."""
    port, ref, _ = runs
    _held(port[name], ref[name])


def test_sharded_leaves_of_the_families(runs):
    """The leaves the layouts shard: the Mamba column linears' ``lora_b``
    and ``conv_x``, not the replicated ``a_log`` or ``bc_proj``; Zamba2's
    per-site ``lora_b`` stacks of column linears and ``lora_a`` of row
    ones; the cross-attention's q."""
    port, _, _ = runs
    mamba = port["mamba"]["sharded"]
    assert "blocks.mamba.z_proj.w" in mamba
    assert "blocks.mamba.conv_x" in mamba
    assert "blocks.mamba.a_log" not in mamba
    assert "blocks.mamba.bc_proj.w" not in mamba
    site = port["zamba_lora"]["sharded"]
    assert "shared.site_lora.attn_q.lora_b" in site
    assert "shared.site_lora.mlp_down.lora_a" in site
    assert "shared.site_lora.attn_q.lora_a" not in site
    assert "cross.xattn.q.w" in port["seamless"]["sharded"]


@pytest.mark.parametrize("name", DECODES)
def test_family_decode_matches_jax(runs, name):
    """The sharded decode (caches by ``cache_specs``: SSM state heads and
    ``conv_x`` channels over "model", KV heads, the enc-dec's ``enc_out``
    rows from the sharded encoder) against JAX's unsharded
    ``decode_step`` fed the same tokens: 3 steps at batch 4."""
    port, ref, _ = runs
    got, want = port[f"{name}.decode"], ref[f"{name}.decode"]
    for a, b in zip(got["logits"], want["logits"], strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4)
    local = got["cache_local"]
    if name == "mamba":
        assert local["state"] == [3, 2, 4, 16, 16]
        assert local["conv_x"] == [3, 2, 3, 64]
    if name == "mamba_split":     # one head: the state whole on each rank
        assert local["state"] == [3, 2, 1, 128, 16]


@pytest.mark.parametrize("name", ["bf16", "bf16_seq"])
def test_bf16_sharded_step_matches_jax(runs, name):
    """A bf16 quantized ``"lora"`` step on the mesh, whose all-gathers of
    bf16 activations and gradients go through gloo, against JAX's
    unsharded bf16 step under ``train_sharded``'s bounds."""
    _, _, cs = _chip_scripts()
    port, ref, _ = runs
    got, want = port[name], ref[name]
    for a, b in zip(got["metrics"], want["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= cs.LOSS_LIMIT * abs(b["loss"])
    a, b = got["metrics"][0]["grad_norm"], want["metrics"][0]["grad_norm"]
    assert abs(a - b) <= cs.SHARDED_NORM_REL * abs(b)
    assert got["equal_on_ranks"]
    for path, w in want["grads"].items():
        if not w.size:
            continue
        g = got["grads"][path].astype(np.float64)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= cs.SHARDED_GRAD_REL, (path, rel)
        lw = want["leaves"][path]
        lim = 2 * LR + 2.0 ** -7 * np.abs(lw).max()
        assert np.abs(got["leaves"][path] - lw).max() <= lim, path


def _chip_scripts():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_fault_check", ROOT / "chip_fault_check.py")
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    return ROOT, fc, cs


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("family", COUNTED)
def test_chip_smoke_predicts_the_collectives(runs, family, seq):
    """``chip_smoke.predicted_collectives`` for each family's structure
    (Mamba blocks with the gated norm's all-reduce, a hybrid's segments
    of blocks run three times forward, the enc-dec's encoder and
    cross-attention, a vision prefix) equals the calls each rank made in
    a ``"lora"`` step of the smoke model under ``remat="full"``, with and
    without ``seq_shard``."""
    port, _, _ = runs
    _, _, cs = _chip_scripts()
    cfg = tc.get_smoke_config(FAMILIES[family][0])
    want = cs.predicted_collectives(cfg, seq)
    for step in port[f"count.{family}.{int(seq)}"]["collectives"]:
        assert {k: v["calls"] for k, v in step.items()} == want


def test_chip_smoke_shard_shapes_follow_each_linears_role():
    """``chip_smoke.shard_shapes`` (the kernel cases at ``train_sharded``'s
    shard shapes) holds each family's column linears at (K, N / 2) and
    its row linears at (K / 2, N), by role and not by width: Seamless's
    self and cross q/k/v (1024 x 1024) give (1024, 512), Zamba2's shared
    q/k/v (3584 x 3584) give (3584, 1792)."""
    _, _, cs = _chip_scripts()
    want = set()
    for arch, _, _ in cs.SHARDED_FAMILIES:
        c = tc.get_config(arch)
        if c.family in ("ssm", "hybrid"):
            h = c.ssm_cfg().d_inner // 2
            want |= {(c.d_model, h), (h, c.d_model)}
        if c.family != "ssm":
            q, kv, f = (c.n_heads * c.head_dim // 2,
                        c.n_kv_heads * c.head_dim // 2, c.d_ff // 2)
            want |= {(c.d_model, q), (c.d_model, kv), (q, c.d_model),
                     (c.d_model, f), (f, c.d_model)}
    got = set(cs.shard_shapes())
    assert got == want
    assert {(1024, 512), (3584, 1792)} <= got


def test_fault_check_needs_a_numerical_check_for_the_gated_plant():
    """chip_fault_check.py counts the seventh plant caught only where each
    Mamba family fails on its gradients or its decode logits: the
    collective count, which the dropped all-reduce changes by
    construction, is not enough."""
    _, fc, _ = _chip_scripts()
    counts = [f"{a}:{r}:collectives" for a in fc.GATED_FAMILIES
              for r in ("tp", "seq")]
    assert not fc.gated_caught([])
    assert not fc.gated_caught([{"failed_checks": counts}])
    assert not fc.gated_caught(
        [{"failed_checks": counts + ["mamba2-370m:grad"]}])
    assert fc.gated_caught([{"failed_checks": counts + [
        "mamba2-370m:grad", "zamba2-7b:decode"]}])


def test_fault_check_plants_the_gated_norm_fault(runs):
    """chip_fault_check.py's seventh plant (the gated norm over the rank's
    channels, its all-reduce dropped) changes one line of
    ``models/modules.py``, and the Mamba2 case of this file fails on it:
    the ranks run on a copy of the package with the plant in place."""
    root, fc, _ = _chip_scripts()
    sound = (root / fc.GATED_SOURCE).read_text()
    fault = fc.plant_gated_fault(sound)
    changed = [(a, b) for a, b in zip(sound.splitlines(), fault.splitlines())
               if a != b]
    assert len(sound.splitlines()) == len(fault.splitlines())
    assert changed == [(fc.GATED_SOUND, fc.GATED_FAULT)]
    with pytest.raises(ValueError):
        fc.plant_gated_fault(fault)
    _, ref, work = runs
    inp = torch.load(work / "all.inputs.pt", weights_only=False)
    torch.save({"mamba": {k: v for k, v in inp["mamba"].items()
                          if k != "decode"}}, work / "fault.inputs.pt")
    copy = work / "fault_src"
    import shutil
    shutil.copytree(ROOT / "src" / "repro_torch", copy / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / fc.GATED_SOURCE.relative_to("src")).write_text(fault)
    code = ("import sys; from tests import torch_sharded_families_worker "
            "as w; from repro_torch.launch import mesh; "
            "mesh.spawn_ranks(w.run, 4, backend='gloo', device='cpu', "
            "args=(sys.argv[1], 'fault'), threads=1, store_dir=sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy), str(ROOT), SRC]))
    proc = subprocess.run([sys.executable, "-c", code, str(work)], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(work / "fault.outputs.pkl", "rb") as f:
        got = pickle.load(f)
    with pytest.raises(AssertionError):
        _held(got["mamba"], ref["mamba"])
