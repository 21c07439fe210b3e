"""Port parity: the enc-dec family (seamless-m4t-medium) and the
vision-prefix dense model (pixtral-12b) against the JAX package, on the
CPU: their data, cross-attention, forward, loss, LoRA gradients and
decode in both layouts, calibration with the cross-attention Gram keys,
both quantization engines, the carry of params, allocation groups,
checkpoints and the CLIs.  (Their config fields are held in
``tests/test_torch_configs.py``, their manifests in
``tests/test_torch_manifest.py``.)

The same numpy params and inputs go through ``repro`` and
``repro_torch``.  Tolerances: logits, losses, gradients, decode and
Grams within 1e-4 (atol and rtol; f32 sums in another order), the
port's rule for f32 paths; RTN codes, scales and zeros bit-exact; CLoQ
leaves within ``tests/test_torch_pipeline.py``'s near-tie bounds (codes
>= 98% equal a site and 99.9% over the model, scales rtol 1e-6, zeros
equal, Qd atol 2e-4 where codes agree, ``A @ B^T`` within 1e-3 relative
Frobenius of JAX's, or of JAX's ``cloq_init`` on the port's residual
where a column flipped); greedy tokens exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.core import allocate as jallocate
from repro.core import cloq as jcloq
from repro.core import pipeline as jp
from repro.core.health import HealthReport as JReport
from repro.core.quantizer import unpack_codes
from repro.core.recipe import QuantRecipe as JRecipe
from repro.data import DataConfig as JDC
from repro.data import TokenStream as JTS
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.modules import QSpec as JQSpec
from repro.utils import tree_paths as jpaths
from repro_torch import configs as tc
from repro_torch.core import allocate as tallocate
from repro_torch.core import pipeline as tp
from repro_torch.core.health import HealthReport
from repro_torch.core.recipe import QuantRecipe as TRecipe
from repro_torch.data import DataConfig as TDC
from repro_torch.data import TokenStream as TTS
from repro_torch.data import data_kind
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.utils import tree_paths as tpaths
from tests.test_torch_pipeline import _qd
from tests.test_torch_ssm import _lora_grads_match
from tests.torch_parity import jax_to_numpy, port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("seamless-m4t-medium", "pixtral-12b")
QS = dict(bits=4, group_size=16, rank=8)
CROSS = ("q", "k", "v", "o")


def _cfgs(arch, **kw):
    return jc.get_smoke_config(arch, **kw), tc.get_smoke_config(arch, **kw)


def _stream_kw(cfg, seq_len=16, batch=2, seed=3, enc_len=8):
    return dict(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                seed=seed, kind=data_kind(cfg), enc_len=enc_len,
                n_prefix=cfg.n_prefix, d_model=cfg.d_model)


def _batches(cfg, **kw):
    """One batch of the model's data kind from both packages' streams."""
    skw = _stream_kw(cfg, **kw)
    bj, bt = JTS(JDC(**skw)).next_batch(), TTS(TDC(**skw)).next_batch()
    return {k: jnp.asarray(v) for k, v in bj.items()}, bt


@pytest.fixture(scope="module", params=[(a, s) for a in ARCHS
                                        for s in (True, False)],
                ids=[f"{a}-{'scan' if s else 'eager'}" for a in ARCHS
                     for s in (True, False)])
def smoke(request):
    """The smoke model, LoRA rank 4 on every linear and every ``lora_b``
    drawn, in either layout."""
    arch, scan = request.param
    cfg_j, cfg_t = _cfgs(arch, lora_rank=4, scan_layers=scan)
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


@pytest.mark.parametrize("kind", ["encdec", "vlm"])
def test_batches_are_byte_identical(kind):
    """Tokens, labels and the frontend stub's f32 embeddings, two batches
    a stream, byte for byte."""
    kw = dict(vocab=512, seq_len=12, global_batch=3, seed=4, kind=kind,
              enc_len=5, n_prefix=6, d_model=16)
    js, ts = JTS(JDC(**kw)), TTS(TDC(**kw))
    for _ in range(2):
        bj, bt = js.next_batch(), ts.next_batch()
        assert sorted(bj) == sorted(bt)
        for k in bj:
            a, b = np.asarray(bj[k]), bt[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    extra = "enc_embeds" if kind == "encdec" else "prefix_embeds"
    assert tuple(bt[extra].shape) == ((3, 5, 16) if kind == "encdec"
                                      else (3, 6, 16))
    with pytest.raises(ValueError, match="kind"):
        TTS(TDC(**dict(kw, kind="audio")))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attn_matches_jax(qk_norm):
    """Queries from 5 positions over keys and values projected from 7
    source positions, GQA 4/2, with and without qk-norm."""
    acfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                qk_norm=qk_norm, causal=False)
    pj = jattn.attn_init(jax.random.PRNGKey(1),
                         jattn.AttnConfig(**acfg), dtype=jnp.float32)
    pn = jax_to_numpy(pj)
    pt = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in pn.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    src = rng.normal(size=(2, 7, 32)).astype(np.float32)
    want = jattn.cross_attn_apply(pj, jattn.AttnConfig(**acfg),
                                  jnp.asarray(x), jnp.asarray(src))
    got = tattn.cross_attn_apply(pt, tattn.AttnConfig(**acfg),
                                 torch.from_numpy(x), torch.from_numpy(src))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_init_params_are_the_references(smoke):
    """``init_params``' tree: the reference's paths, shapes and dtypes
    (``enc_blocks``, ``dec_blocks``, ``cross`` and ``enc_norm`` for
    enc-dec, ``blocks`` for the vision model)."""
    cfg_j, cfg_t, pj, _ = smoke
    mine = tpaths(tt.init_params(cfg_t, seed=0, device="cpu"))
    ref = jpaths(pj)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == tuple(v.shape), k
        assert str(mine[k].dtype).split(".")[-1] == jnp.dtype(v.dtype).name
    if cfg_t.family == "encdec":
        assert {p.split(".")[0] for p in mine} == {
            "embed", "head", "final_norm", "enc_blocks", "dec_blocks",
            "cross", "enc_norm"}


def test_forward_loss_and_lora_grads_match_jax(smoke):
    """Logits (text positions only for the vision model) and ``loss_fn``
    in both layouts; in the scan layout every LoRA gradient, the
    cross-attention's and the encoder's included."""
    cfg_j, cfg_t, pj, pt = smoke
    bj, bt = _batches(cfg_j)
    lj, _ = jt.forward(pj, cfg_j, bj)
    lt, aux = tt.forward(pt, cfg_t, bt)
    assert tuple(lt.shape) == (2, 16, cfg_t.vocab_padded)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    assert float(aux) == 0.0
    if cfg_t.scan_layers:
        must = ("cross.xattn.k" if cfg_t.family == "encdec"
                else "blocks.mlp.down")
        _lora_grads_match(cfg_j, cfg_t, pj, pt, bj, bt, must)
    else:
        np.testing.assert_allclose(
            tt.loss_fn(pt, cfg_t, bt)[0].item(),
            float(jt.loss_fn(pj, cfg_j, bj)[0]), **TOL)


def test_decode_matches_jax(smoke):
    """Three greedy decode steps at batch 2 into an 8-position cache, an
    enc-dec model's against a random non-zero ``enc_out``: logits within
    1e-4 and equal tokens each step; the port's K/V tensors are written
    in place."""
    cfg_j, cfg_t, pj, pt = smoke
    cj = jt.init_decode_cache(cfg_j, 2, 8)
    ct = tt.init_decode_cache(cfg_t, 2, 8, device="cpu")
    assert sorted(ct) == sorted(cj)
    if cfg_t.family == "encdec":
        enc = np.random.default_rng(9).normal(
            size=(2, 8, cfg_t.d_model)).astype(np.float32)
        cj["enc_out"] = jnp.asarray(enc)
        ct["enc_out"] = torch.from_numpy(enc)
    K = ct["k"]
    tok = np.array([[5], [300]], np.int32)
    tj, tk = jnp.asarray(tok), torch.from_numpy(tok)
    for _ in range(3):
        lj, cj = jt.decode_step(pj, cfg_j, cj, tj)
        lt, ct = tt.decode_step(pt, cfg_t, ct, tk)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tk = lt.argmax(-1, keepdim=True)
        assert np.array_equal(np.asarray(tj), to_np(tk))
    assert ct["k"] is K
    np.testing.assert_allclose(to_np(ct["k"]), np.asarray(cj["k"]), **TOL)


def test_decoder_sublayer_order_is_each_functions_own():
    """The reference orders a decoder layer's sub-layers differently in
    training (self-attention, MLP, cross-attention) and in decode
    (self-attention, cross-attention, MLP); the port keeps both.  A
    one-token forward and the first decode step over the same encoder
    output each match their own JAX twin, and differ from each other."""
    cfg_j, cfg_t = _cfgs("seamless-m4t-medium")
    pj = jt.init_params(jax.random.PRNGKey(11), cfg_j)
    pt = port_params(pj, cfg_t)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg_t.vocab, (2, 1)).astype(np.int32)
    emb = rng.normal(size=(2, 4, cfg_t.d_model)).astype(np.float32)
    fj, _ = jt.forward(pj, cfg_j, {"tokens": jnp.asarray(toks),
                                   "enc_embeds": jnp.asarray(emb)})
    ft, _ = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks),
                                   "enc_embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(to_np(ft), np.asarray(fj), **TOL)
    enc_out = tt._encode(pt, cfg_t, torch.from_numpy(emb))
    cj = jt.init_decode_cache(cfg_j, 2, 4)
    ct = tt.init_decode_cache(cfg_t, 2, 4, device="cpu")
    cj["enc_out"] = jnp.asarray(to_np(enc_out))
    ct["enc_out"].copy_(enc_out)
    dj, _ = jt.decode_step(pj, cfg_j, cj, jnp.asarray(toks))
    dt, _ = tt.decode_step(pt, cfg_t, ct, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), **TOL)
    gap = np.abs(to_np(dt) - to_np(ft[:, 0])).max()
    assert gap > 1e-2, gap


# -- calibration and quantization ----------------------------------------------


@pytest.fixture(scope="module")
def seamless():
    """seamless's smoke model, a calibration batch of 2 x 32 tokens with 8
    encoder frames, and JAX's sequential CLoQ 4-bit g16 r8 quantization
    with its health guards on (their report and the Grams)."""
    cfg_j, cfg_t = _cfgs("seamless-m4t-medium")
    pj = jt.init_params(jax.random.PRNGKey(3), cfg_j)
    bj, bt = _batches(cfg_j, seq_len=32, seed=2)
    jrep = JReport()
    qj, qcfg_j, sj = jp.quantize_model(
        pj, cfg_j, [bj], recipe=JRecipe.single("cloq", JQSpec(**QS)),
        engine="sequential", report=jrep)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=port_params(pj, cfg_t),
                bj=bj, bt=bt, store_j=sj, report_j=jrep,
                ej=jpaths(jax_to_numpy(jp.to_eager_params(pj, cfg_j))),
                lj=jpaths(jax_to_numpy(jp.to_eager_params(qj, qcfg_j))))


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_keys_are_the_references(arch, seamless):
    """``run_calibration``: the reference's Gram keys, values and row
    counts; enc-dec's cross-attention under ``dec_blocks.<i>.cross.<name>``
    (``k``/``v`` over the encoder output's 2 x 8 rows), the vision
    model's over the patches and the text."""
    if arch == "seamless-m4t-medium":
        cfg_t, pt, bt, sj = (seamless[k] for k in ("cfg_t", "pt", "bt",
                                                   "store_j"))
    else:
        cfg_j, cfg_t = _cfgs(arch)
        pj = jt.init_params(jax.random.PRNGKey(3), cfg_j)
        pt = port_params(pj, cfg_t)
        bj, bt = _batches(cfg_j, seq_len=32, seed=2)
        sj = jp.run_calibration(jp.to_eager_params(pj, cfg_j), cfg_j, [bj])
    st = tp.run_calibration(pt, cfg_t, [bt])
    assert sorted(st.grams) == sorted(sj.grams)
    for k, h in st.grams.items():
        np.testing.assert_allclose(to_np(h), np.asarray(sj.grams[k]),
                                   err_msg=k, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(
                                       np.asarray(sj.grams[k])).max()))
        assert st.counts[k] == sj.counts[k], k
    if cfg_t.family == "encdec":
        cross = sorted(k for k in st.grams if ".cross." in k)
        assert cross == sorted(f"dec_blocks.{i}.cross.{n}"
                               for i in range(2) for n in CROSS)
        assert st.counts["dec_blocks.0.cross.k"] == 2 * 8
        assert st.counts["dec_blocks.0.cross.q"] == 2 * 32
        assert len(st.grams) == 2 * 7 + 2 * 7 + 2 * 4
    else:
        assert st.counts["blocks.0.attn.q"] == 2 * (32 + cfg_t.n_prefix)


def _codes(leaf: dict, m: int) -> np.ndarray:
    return np.asarray(unpack_codes(jnp.asarray(leaf["qcodes"]), 4, m))


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_quantize_encdec_cloq_matches_jax(seamless, engine):
    """Both port engines against JAX's sequential engine, CLoQ 4-bit g16
    r8: every site of the encoder, the decoder and the cross-attention
    (36) within the near-tie bounds, the health report equal to JAX's
    (all 36 clean), norms and embeddings carried unchanged."""
    s = seamless
    report = HealthReport()
    qt, qcfg, _ = tp.quantize_model(
        s["pt"], s["cfg_t"], [s["bt"]], engine=engine, report=report,
        recipe=TRecipe.single("cloq", TQSpec(**QS)))
    assert report.to_dict() == s["report_j"].to_dict()
    assert report.checked == 36 and not report.counts()
    lt = {k: to_np(v) for k, v in tpaths(tp.to_eager_params(qt, qcfg))
          .items()}
    lj = s["lj"]
    assert sorted(lt) == sorted(lj)
    sites = sorted({p.rsplit(".", 1)[0] for p in lj if p.endswith("qcodes")})
    assert len(sites) == 36
    assert [p for p in sites if p.startswith("cross.")] == [
        f"cross.{i}.xattn.{n}" for i in range(2) for n in sorted(CROSS)]
    n_codes = n_same = 0
    for site in sites:
        t = {k: lt[f"{site}.{k}"] for k in ("qcodes", "scales", "zeros",
                                            "lora_a", "lora_b")}
        j = {k: lj[f"{site}.{k}"] for k in t}
        m = j["lora_a"].shape[0]
        same = _codes(t, m) == _codes(j, m)
        n_codes += same.size
        n_same += int(same.sum())
        assert same.mean() >= 0.98, (site, same.mean())
        np.testing.assert_allclose(t["scales"], j["scales"], rtol=1e-6)
        np.testing.assert_array_equal(t["zeros"], j["zeros"])
        np.testing.assert_allclose(_qd(t, m)[same], _qd(j, m)[same],
                                   atol=2e-4)
        abt = t["lora_a"] @ t["lora_b"].T
        if same.all():
            abj = j["lora_a"] @ j["lora_b"].T
        else:       # the JAX solve on the port's own residual W - Qd
            H = s["store_j"].gram(jp._scope_for(site))
            A, B = jcloq.cloq_init(jcloq.regularize_gram(jnp.asarray(H)),
                                   jnp.asarray(s["ej"][f"{site}.w"]
                                               - _qd(t, m)), 8)
            abj = np.asarray(A @ B.T)
        rel = np.linalg.norm(abt - abj) / np.linalg.norm(abj)
        assert rel <= 1e-3, (site, rel)
    assert n_same / n_codes >= 0.999, n_same / n_codes
    for path in ("embed.w", "head.w", "enc_norm.scale", "cross.1.ln.scale",
                 "dec_blocks.0.ln1.scale"):
        np.testing.assert_array_equal(lt[path], lj[path])


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_quantize_encdec_rtn_is_bit_exact(seamless, engine):
    """RTN 4-bit g16 on seamless in the scan layout: every site's codes,
    scales and zeros bit-equal to those of JAX's sequential engine (its
    batched engine's fused bucket rounds some scales one ulp apart),
    cross-attention sites included, and the three containers re-stacked."""
    s = seamless
    recipe = dict(bits=4, group_size=16, rank=4)
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    qj, qcfg_j, _ = jp.quantize_model(
        s["pj"], cfg_j, [s["bj"]], engine="sequential",
        recipe=JRecipe.single(
            "rtn", JQSpec(**recipe, method="rtn")))
    qt, qcfg_t, _ = tp.quantize_model(
        s["pt"], cfg_t, [s["bt"]], engine=engine, recipe=TRecipe.single(
            "rtn", TQSpec(**recipe, method="rtn")))
    lj, lt = jpaths(jax_to_numpy(qj)), tpaths(qt)
    assert sorted(lt) == sorted(lj)
    assert tuple(lt["cross.xattn.k.qcodes"].shape) == (2, 32, 64)
    n = 0
    for p, v in lj.items():
        if p.rsplit(".", 1)[-1] in ("qcodes", "scales", "zeros"):
            np.testing.assert_array_equal(to_np(lt[p]), v, err_msg=p)
            n += 1
    assert n == 3 * (7 + 7 + 4)


def test_scan_uniform_check_names_the_container(seamless):
    """A recipe that is not layer-uniform within ``cross`` is refused in
    the scan layout, naming the container; the eager layout takes it."""
    s = seamless
    rule = TRecipe(rules=(dict(pattern="cross.0.*", skip=True),),
                   qspec=TQSpec(**QS))
    with pytest.raises(ValueError, match="'cross'"):
        tp.quantize_model(s["pt"], s["cfg_t"], [s["bt"]], recipe=rule)
    eager = dataclasses.replace(s["cfg_t"], scan_layers=False)
    qt, _, _ = tp.quantize_model(tp.to_eager_params(s["pt"], s["cfg_t"]),
                                 eager, [s["bt"]], recipe=rule)
    assert "w" in qt["cross"]["0"]["xattn"]["k"]
    assert "qcodes" in qt["cross"]["1"]["xattn"]["k"]


def test_allocation_groups_the_new_containers_as_jax(seamless):
    """``allocate.group_sites`` over the scan containers folds each
    container's layers into one group, the reference's patterns
    (``cross.*.xattn.k``, ``enc_blocks.*.mlp.up``, ...) and geometry."""
    s = seamless
    et = tp.to_eager_params(s["pt"], s["cfg_t"])
    store = tp.run_calibration(s["pt"], s["cfg_t"], [s["bt"]])
    got = tallocate.group_sites(tp._allocation_meta(et, store),
                                tuple(tp._STACK_KEYS))
    ej = jp.to_eager_params(s["pj"], s["cfg_j"])
    want = jallocate.group_sites(jp._allocation_meta(ej, s["store_j"]),
                                 tuple(jp._STACK_KEYS))
    assert [(g.pattern, g.paths, g.m, g.n) for g in got] == \
        [(g.pattern, g.paths, g.m, g.n) for g in want]
    assert len(got) == 7 + 7 + 4
    assert "cross.*.xattn.k" in {g.pattern for g in got}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_both_ways(arch):
    """A scan-stacked JAX tree carried into an eager config and an eager
    one into a scan config: every container (``enc_blocks``,
    ``dec_blocks``, ``cross`` or ``blocks``) re-laid, leaves equal to
    JAX's own re-layout."""
    cfg_j, cfg_t = _cfgs(arch)
    pj = jt.init_params(jax.random.PRNGKey(4), cfg_j)
    eager_j = jp.to_eager_params(pj, cfg_j)
    eager_t = port_params(pj, dataclasses.replace(cfg_t, scan_layers=False))
    want = jpaths(jax_to_numpy(eager_j))
    got = tpaths(eager_t)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(to_np(got[k]), v, err_msg=k)
    scan_t = port_params(eager_j, cfg_t)
    want = jpaths(jax_to_numpy(pj))
    got = tpaths(scan_t)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(to_np(got[k]), v, err_msg=k)


# -- serving and the CLIs -------------------------------------------------------


def test_fixed_slots_match_jax_decode_over_an_encoder_output(seamless):
    """The JAX-quantized seamless smoke model carried over and served by
    the port's fixed-slot loop (batch 2, 4 requests x 4 tokens into an
    8-position cache) against an ``enc_out`` from the port's encoder:
    each step's logits within 1e-4 and its greedy tokens equal to JAX's
    ``decode_step`` driven over the same inputs and encoder output."""
    from repro_torch.launch import serve
    s = seamless
    qj, qcfg_j, _ = jp.quantize_model(
        s["pj"], s["cfg_j"], [s["bj"]],
        recipe=JRecipe.single("cloq", JQSpec(**QS)))
    qcfg_t = dataclasses.replace(s["cfg_t"], quant=TQSpec(**QS))
    qt = port_params(qj, qcfg_t)
    emb = np.random.default_rng(13).normal(
        size=(2, 8, qcfg_t.d_model)).astype(np.float32)
    enc_out = tt._encode(qt, qcfg_t, torch.from_numpy(emb))
    res = serve.serve_fixed_slots(qt, qcfg_t, batch=2, cache_len=8,
                                  requests=4, max_new=4, seed=1,
                                  device="cpu", keep_logits=True,
                                  enc_out=enc_out)
    assert res["requests_done"] == 4 and res["steps"] == 8
    cache = jt.init_decode_cache(qcfg_j, 2, 8)
    cache["enc_out"] = jnp.asarray(to_np(enc_out))
    step = jax.jit(lambda p, c, t: jt.decode_step(p, qcfg_j, c, t))
    for inp, out, lt in zip(res["inputs"], res["outputs"], res["logits"]):
        lj, cache = step(qj, cache, jnp.asarray(inp[:, None].astype(np.int32)))
        np.testing.assert_allclose(lt, np.asarray(lj), **TOL)
        assert np.array_equal(np.asarray(jnp.argmax(lj, -1)), out)


CLI = ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
       "--batch", "2", "--calib-batches", "1"]


def _plain_run(arch, use_kernel: bool) -> list[float]:
    """The train CLI's steps rebuilt from its parts: the same init, data
    stream (the model's kind, ``max(seq_len // 4, 8)`` frames), CLoQ
    4-bit g64 r64 and 3 steps; ``use_kernel`` routes every quantized
    linear through the kernel wrappers (their plain versions on the
    CPU)."""
    from repro_torch.launch.steps import build_state, make_train_step
    from repro_torch.models.parallel import LOCAL
    from repro_torch.optim import OptConfig
    cfg = tc.get_smoke_config(arch)
    params = tt.init_params(cfg, seed=0, device="cpu")
    stream = TTS(TDC(**_stream_kw(cfg, seq_len=32, seed=0, enc_len=8)))
    calib = [stream.next_batch()]
    params, cfg, _ = tp.quantize_model(
        params, cfg, calib, recipe=TRecipe.single(
            "cloq", TQSpec(bits=4, group_size=64, rank=64, method="cloq")))
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, use_kernel=use_kernel))
    ocfg = OptConfig(lr=3e-4, trainable="lora", total_steps=3,
                     schedule="cosine")
    state, step = build_state(params, ocfg), make_train_step(cfg, ocfg, LOCAL)
    losses = []
    for _ in range(3):
        state, m = step(state, stream.next_batch())
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_and_matches_the_plain_path(arch, capsys):
    """``repro_torch.launch.train --arch <arch> --smoke --device cpu``:
    every site checked clean (36 for seamless: 14 encoder, 14 decoder, 8
    cross-attention; 14 for pixtral), finite losses equal to the CLI's
    steps rebuilt from its parts, and within 1e-4 of the same steps
    through the kernel wrappers."""
    from repro_torch.launch import train
    res = train.run(train.build_parser().parse_args(["--arch", arch, *CLI]))
    out = capsys.readouterr().out
    n = 36 if arch.startswith("seamless") else 14
    assert f"health: {n} slices checked, all clean" in out, out
    assert all(np.isfinite(res["losses"])) and len(res["losses"]) == 3
    np.testing.assert_allclose(res["losses"], _plain_run(arch, False),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["losses"], _plain_run(arch, True), **TOL)


def test_train_cli_checkpoint_carries_the_manifest(tmp_path):
    """A seamless run with ``--ckpt-dir`` saves its state with the bucket
    manifest of its recipe (the four containers listed as stacked), and a
    ``--resume`` run restores it and continues from the saved step."""
    from repro_torch.checkpoint.manager import MANIFEST_KEY
    from repro_torch.launch import train
    d = str(tmp_path / "ck")
    flags = ["--arch", "seamless-m4t-medium", *CLI[:3], "--seq-len", "16",
             "--batch", "2", "--calib-batches", "1", "--ckpt-dir", d,
             "--ckpt-every", "1"]
    res = train.run(train.build_parser().parse_args(flags + ["--steps",
                                                             "2"]))
    assert res["ckpt_step"] == 2
    meta = json.loads((tmp_path / "ck" / "step_00000002" /
                       "meta.json").read_text())
    man = meta[MANIFEST_KEY]
    assert man == tp.quantization_manifest(
        res["cfg"], recipe=TRecipe.from_dict(man["recipe"]))
    assert man["stacked"] == ["enc_blocks", "dec_blocks", "cross"]
    again = train.run(train.build_parser().parse_args(
        flags + ["--steps", "3", "--resume"]))
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    assert np.isfinite(again["losses"]).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_routes_as_jax(arch):
    """``repro_torch.launch.serve --arch <arch> --smoke --device cpu``:
    seamless by the fixed-slot loop (an ``enc_out`` of zeros, as the JAX
    CLI), pixtral (dense, scan) by the engine; every request served."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(["--arch", arch, "--smoke",
                                            "--device", "cpu"])
    res = serve.run(args)
    s = res["serve"]
    assert s["requests_done"] == args.requests
    if arch.startswith("seamless"):
        assert res["route"] == "fixed_slots" and s["all_finite"]
        assert s["slot_tokens"] == 128
    else:
        assert res["route"] == "engine" and s["tokens"] == 8 * 16
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "2"]) == 0


def test_vision_prefix_positions_are_dropped():
    """A vision model's forward over ``n_prefix`` patches and 6 tokens
    gives logits for the 6 text positions only, and without
    ``prefix_embeds`` it runs on the text alone, as the JAX twin."""
    cfg_j, cfg_t = _cfgs("pixtral-12b")
    pj = jt.init_params(jax.random.PRNGKey(8), cfg_j)
    pt = port_params(pj, cfg_t)
    toks = np.arange(12, dtype=np.int32).reshape(2, 6)
    lt, _ = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    lj, _ = jt.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    pre = np.ones((2, cfg_t.n_prefix, cfg_t.d_model), np.float32)
    lp, _ = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks),
                                   "prefix_embeds": torch.from_numpy(pre)})
    assert tuple(lp.shape) == tuple(lt.shape)
    assert float((lp - lt).abs().max()) > 1e-3
    hid, _ = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks),
                                    "prefix_embeds": torch.from_numpy(pre)},
                        return_hidden=True)
    assert tuple(hid.shape) == (2, 6, cfg_t.d_model)
