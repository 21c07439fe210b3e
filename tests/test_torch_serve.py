"""The whole slice on the CPU: the port's ``launch.serve`` against the JAX
package's greedy fixed-slot loop from the same CLoQ-quantized params.

The params are quantized once by JAX (sequential engine, health guards
off) and carried into the port.  Both loops run the smoke model in f32.
Tokens must be equal at every step; a step whose top-2 logit margin is
under 1e-3 is compared by its logits instead (atol 1e-4, the f32 decode
tolerance), and if its tokens differ the two runs are fed different inputs
from there on, so the comparison ends at that step.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import pipeline as jp
from repro.core.health import HealthPolicy
from repro.core.recipe import QuantRecipe
from repro.data import DataConfig, TokenStream
from repro.launch.steps import make_decode_step
from repro.models import modules as jmod
from repro.models.parallel import LOCAL
from repro.models.transformer import init_decode_cache, init_params
from repro_torch.launch import serve
from repro_torch.models import modules as tmod
from tests.torch_parity import configs, port_params

B, CACHE, REQUESTS, MAX_NEW, SEED = 4, 64, 8, 16, 0


def _jax_serve(params, cfg):
    """The JAX CLI's fixed-slot loop (``repro.launch.serve._serve_legacy``),
    recording each step's inputs and logits."""
    cache = init_decode_cache(cfg, B, CACHE)
    step = jax.jit(make_decode_step(cfg, LOCAL))
    rng = np.random.default_rng(SEED)
    queue = [int(rng.integers(1, cfg.vocab)) for _ in range(REQUESTS)]
    slots = [None] * B
    current = np.zeros((B, 1), np.int32)
    done, inputs, logits_all = 0, [], []
    while done < REQUESTS:
        for s in range(B):
            if slots[s] is None and queue:
                slots[s] = MAX_NEW
                current[s, 0] = queue.pop(0)
        inputs.append(current[:, 0].copy())
        logits, cache = step(params, cache, jnp.asarray(current))
        logits = np.asarray(logits)
        logits_all.append(logits)
        nxt = logits.argmax(-1)
        for s in range(B):
            if slots[s] is None:
                continue
            slots[s] -= 1
            current[s, 0] = int(nxt[s]) % cfg.vocab
            if slots[s] <= 0:
                done += 1
                slots[s] = None
    return inputs, logits_all


@pytest.fixture(scope="module")
def quantized():
    cfg_j, cfg_t = configs()
    pj = init_params(jax.random.PRNGKey(SEED), cfg_j)
    calib = [TokenStream(DataConfig(vocab=cfg_j.vocab, seq_len=64,
                                    global_batch=2, seed=SEED)).next_batch()]
    qspec = dict(bits=4, group_size=16, rank=8)
    qj, cfg_j, _ = jp.quantize_model(
        pj, cfg_j, calib,
        recipe=QuantRecipe.single("cloq", jmod.QSpec(**qspec)),
        engine="sequential", policy=HealthPolicy(enabled=False))
    cfg_t = dataclasses.replace(cfg_t, quant=tmod.QSpec(**qspec))
    return qj, cfg_j, port_params(qj, cfg_t), cfg_t


@pytest.mark.parametrize("kernel", [False, True])
def test_slice_greedy_tokens_match_jax(quantized, kernel):
    qj, cfg_j, qt, cfg_t = quantized
    cfg_j = dataclasses.replace(cfg_j, quant=dataclasses.replace(
        cfg_j.quant, use_kernel=kernel))
    cfg_t = dataclasses.replace(cfg_t, quant=dataclasses.replace(
        cfg_t.quant, use_kernel=kernel))
    inputs_j, logits_j = _jax_serve(qj, cfg_j)
    res = serve.serve_fixed_slots(
        qt, cfg_t, batch=B, cache_len=CACHE, requests=REQUESTS,
        max_new=MAX_NEW, seed=SEED, device="cpu", keep_logits=True)
    assert res["requests_done"] == REQUESTS and res["all_finite"]
    assert res["steps"] == len(logits_j) == REQUESTS * MAX_NEW // B
    compared = 0
    for step, (lj, lt) in enumerate(zip(logits_j, res["logits"])):
        np.testing.assert_array_equal(res["inputs"][step], inputs_j[step])
        np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=1e-4)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        near_tie = top2[:, 1] - top2[:, 0] < 1e-3
        same = lt.argmax(-1) == lj.argmax(-1)
        assert (same | near_tie).all(), step
        compared += 1
        if not same.all():
            break
    assert compared >= 16


def test_serve_cli_on_cpu(capsys):
    """A CLoQ model has adapter sites, so the CLI takes the multi-tenant
    engine's route (as the JAX CLI does): 4 one-token requests of 4 new
    tokens, one at each of the 4 default tenants' slots of one rank-8
    bucket, decode together.  ``--method none`` keeps the fixed-slot
    loop."""
    rc = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     "--requests", "4", "--max-new", "4", "--kernel"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] requests=4/4 steps=4 tokens=16 " in out
    assert "tenants=4 rank_buckets=8 " in out
    rc = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     "--requests", "4", "--max-new", "4", "--method", "none"])
    assert rc == 0
    assert "[serve] requests=4/4 steps=4 slot_tokens=16" in \
        capsys.readouterr().out


def test_serve_rejects_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """Every flag of the JAX CLI is ported: ``--compile-cache`` is taken
    beside the others and the CLI prints the JAX CLI's cache fields, plus
    ``cache_corrupt``, ``cache_unportable`` and the libraries loaded
    (none on the CPU); bad arguments still raise."""
    from repro_torch.kernels import build
    monkeypatch.chdir(tmp_path)     # a trace, if asked for, lands here
    monkeypatch.setattr(build, "_cache", None)
    for flag in (["--compile-cache", "x"],
                 ["--cost-cal", "c.json", "--method", "none",
                  "--compile-cache", "x"],
                 ["--compile-cache", "x", "--trace-out", "t.json"],
                 ["--cost-cal", "c.json", "--metrics-out", "m.json",
                  "--method", "none", "--compile-cache", "x"]):
        assert serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                           "cpu", "--tenants", "2", "--requests", "2",
                           "--max-new", "2", "--tokens-out", "tok.json",
                           *flag]) == 0
        out = capsys.readouterr().out
        assert "[serve] decode cache_hits=0 cache_misses=0 cache_corrupt=0 " \
            "cache_unportable=0 libraries=none launches=none" in out
        assert build.active_cache().directory == tmp_path / "x"
        toks = json.loads((tmp_path / "tok.json").read_text())
        assert toks["route"] == ("fixed_slots" if "none" in flag
                                 else "engine")
        assert len(toks["outputs"]) == 2        # requests, or steps
    assert not (tmp_path / "x").exists(), "nothing built on the CPU"
    serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                "--requests", "2", "--max-new", "2"])
    assert "cache_hits" not in capsys.readouterr().out
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="cache-len"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--cache-len", "8"])
