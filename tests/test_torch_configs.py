"""Port parity: the architecture registry (``repro_torch.configs``) and the
dense configs beyond Qwen3-1.7B, against the JAX package, on the CPU.

Each ported config (published and smoke) carries the reference's fields
exactly; the dtypes are the same type under each framework's name.  The
smoke models of Qwen3-4B, CodeQwen1.5-7B (attention bias, MHA) and
MiniCPM-2B (tied embeddings, head dim 12) give the reference's logits from
the same params, within 1e-4 (atol and rtol; f32 matmuls summed in another
order), and the same greedy decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import transformer as jt
from repro_torch import configs as tc
from repro_torch.models import transformer as tt
from tests.torch_parity import port_params, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ("qwen3-4b", "codeqwen1.5-7b", "minicpm-2b", "olmoe-1b-7b",
       "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b",
       "seamless-m4t-medium", "pixtral-12b")


def test_registry_order_and_aliases_are_the_references():
    """All ten of the reference's architectures in its order, with its
    aliases; an unknown name raises ``KeyError``."""
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert tc.ALIASES == jc.ALIASES
    assert len(tc.ARCH_IDS) == 10
    for name in ("seamless-m4t-medium", "pixtral-12b"):
        assert tc.get_config(name).name == jc.get_config(name).name
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("whisper-large")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_config_fields_are_the_references(arch, smoke):
    get_t = tc.get_smoke_config if smoke else tc.get_config
    get_j = jc.get_smoke_config if smoke else jc.get_config
    ct, cj = get_t(arch), get_j(arch)
    for f in dataclasses.fields(ct):
        vt, vj = getattr(ct, f.name), getattr(cj, f.name)
        if f.name == "dtype":
            assert str(vt).split(".")[-1] == jnp.dtype(vj).name, arch
        else:
            assert vt == vj, (arch, f.name, vt, vj)
    assert ct.vocab_padded == cj.vocab_padded
    if cj.family == "moe":
        assert dataclasses.asdict(ct.moe_cfg()) == \
            dataclasses.asdict(cj.moe_cfg())
    if cj.family in ("ssm", "hybrid"):
        assert dataclasses.asdict(ct.ssm_cfg()) == \
            dataclasses.asdict(cj.ssm_cfg())
        assert ct.n_hybrid_sites == cj.n_hybrid_sites


@pytest.mark.parametrize("arch", ["qwen3-4b", "codeqwen1.5-7b",
                                  "minicpm-2b"])
def test_smoke_forward_and_decode_match_jax(arch):
    """Logits of a forward pass and of three greedy decode steps at batch
    2; CodeQwen's attention bias and MiniCPM's tied head carried over."""
    cfg_j, cfg_t = jc.get_smoke_config(arch), tc.get_smoke_config(arch)
    pj = jt.init_params(jax.random.PRNGKey(7), cfg_j)
    rng = np.random.default_rng(8)
    if cfg_j.attn_bias:                 # non-zero biases, the same both sides
        blocks = jax.tree.map(np.asarray, pj["blocks"])
        for lin in ("q", "k", "v"):
            b = blocks["attn"][lin]["b"]
            blocks["attn"][lin]["b"] = rng.normal(size=b.shape).astype(
                np.float32) * 0.1
        pj = dict(pj, blocks=jax.tree.map(jnp.asarray, blocks))
    pt = port_params(pj, cfg_t)
    assert ("head" in pt) == (not cfg_t.tie_embeddings)
    toks = rng.integers(0, cfg_j.vocab, (2, 10)).astype(np.int32)
    lj, _ = jt.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    lt, _ = tt.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    cj = jt.init_decode_cache(cfg_j, 2, 8)
    ct = tt.init_decode_cache(cfg_t, 2, 8, device="cpu")
    tj = jnp.asarray(toks[:, :1])
    tk = torch.from_numpy(toks[:, :1])
    for _ in range(3):
        lj, cj = jt.decode_step(pj, cfg_j, cj, tj)
        lt, ct = tt.decode_step(pt, cfg_t, ct, tk)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tk = lt.argmax(-1, keepdim=True)
        assert np.array_equal(np.asarray(tj), to_np(tk))
