"""Port parity: the bucket manifest and the abstract plan
(``pipeline.quantization_manifest``, ``recipe_plan_bytes``,
``quantized_param_shapes``, ``recipe.plan_fingerprint``) and checkpoints
that carry the manifest (``save_tree(manifest=)``), against the JAX
package.

Tolerances: none.  For each of the 10 configs at its published size
(abstract shapes cost nothing) and three recipes (one method; a mixed plan
with a ``skip`` rule and other methods, bits and ranks; NF4 ``qlora``)
the manifest is JSON-equal to JAX's and has the same fingerprint, and the
plan's bytes and its leaf shapes and dtypes are JAX's.  On smoke models
the abstract tree is what ``init_params`` and a real ``quantize_model``
give, byte for byte.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.checkpoint.manager import restore_tree as jax_restore
from repro.checkpoint.manager import save_tree as jax_save
from repro.core import pipeline as jp
from repro.core import recipe as jr
from repro.core.compile_cache import canonical_digest as j_digest
from repro.models.modules import QSpec as JQSpec
from repro.utils import tree_paths as jpaths
from repro_torch import configs as tc
from repro_torch.checkpoint import (CheckpointManager, restore_tree,
                                    save_tree)
from repro_torch.checkpoint.manager import MANIFEST_KEY
from repro_torch.core import pipeline as tp
from repro_torch.core import recipe as tr
from repro_torch.models import transformer as tt
from repro_torch.models.modules import QSpec as TQSpec
from repro_torch.utils import get_path
from repro_torch.utils import tree_paths as tpaths
from tests import torch_parity  # noqa: F401  (sets torch's threads)

ARCHS = ("qwen3-1.7b", "qwen3-4b", "codeqwen1.5-7b", "minicpm-2b",
         "olmoe-1b-7b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b",
         "seamless-m4t-medium", "pixtral-12b")
_QS = dict(bits=4, group_size=64, rank=64)
# first match wins: the attention output left dense, the MLPs at 2 bits
# rank 16, MoE experts by RTN at 3 bits (one code a byte) rank 0, the
# Mamba linears by GPTQ at 8 bits
MIXED_RULES = (dict(pattern="*.attn.o", skip=True),
               dict(pattern="*.mlp.*", bits=2, rank=16),
               dict(pattern="*.moe.*", method="rtn", bits=3, rank=0),
               dict(pattern="*.mamba.*", method="gptq", bits=8, rank=8))
RECIPES = {
    "single": lambda R, Q: R.single("cloq", Q(**_QS)),
    "mixed": lambda R, Q: R(rules=MIXED_RULES, method="cloq", qspec=Q(**_QS)),
    "qlora": lambda R, Q: R.single("qlora", Q(**_QS, method="qlora")),
}
_QUANT_LEAVES = ("qcodes", "scales", "zeros", "absmax", "lora_a", "lora_b")


def _recipes(name):
    return (RECIPES[name](jr.QuantRecipe, JQSpec),
            RECIPES[name](tr.QuantRecipe, TQSpec))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return jnp.dtype(x.dtype).name


def _layout(flat: dict) -> dict:
    return {p: (tuple(v.shape), _dtype_name(v)) for p, v in flat.items()}


def test_canonical_digest_is_the_references():
    """The same dicts give the same bytes, so the same sha1: nested
    containers, key order, floats, None, tuples and non-JSON values
    (``default=str``)."""
    objs = [{}, {"b": 1, "a": [1.5, None, True]},
            {"buckets": [{"spec": {"m": 2048, "group_size": None}}],
             "axis": "model"},
            {"x": (1, 2), "y": torch.float32, "z": 1e-3, "w": "é"}]
    for o in objs:
        assert tr.canonical_digest(o) == j_digest(o)
        assert tr.plan_fingerprint(o) == jr.plan_fingerprint(o)
    assert tr.plan_fingerprint({"a": 1, "b": 2}) == \
        tr.plan_fingerprint({"b": 2, "a": 1})


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_shapes_are_init_params(arch):
    """The meta-device tree has ``init_params``'s paths, shapes and
    dtypes (the smoke model, eager and scan-stacked) and allocates
    nothing."""
    cfg = tc.get_smoke_config(arch)
    abstract = tpaths(tp._abstract_eager_shapes(cfg))
    real = tpaths(tt.init_params(dataclasses.replace(cfg, scan_layers=False),
                                 seed=0, device="cpu"))
    assert _layout(abstract) == _layout(real)
    assert all(v.device.type == "meta" for v in abstract.values())


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_bytes_and_shapes_match_jax(arch, recipe):
    """At the published size: ``quantization_manifest`` JSON-equal to
    JAX's with the same ``plan_fingerprint``; ``recipe_plan_bytes`` and
    ``quantized_param_shapes`` (paths, shapes, dtypes; its
    ``with_manifest`` manifest) equal to JAX's."""
    cj, ct = jc.get_config(arch), tc.get_config(arch)
    rj, rt = _recipes(recipe)
    shapes_j, man_j = jp.quantized_param_shapes(cj, recipe=rj,
                                                with_manifest=True)
    shapes_t, man_t = tp.quantized_param_shapes(ct, recipe=rt,
                                                with_manifest=True)
    assert json.dumps(man_t, sort_keys=True) == \
        json.dumps(man_j, sort_keys=True)
    assert tr.plan_fingerprint(man_t) == jr.plan_fingerprint(man_j)
    assert tp.quantization_manifest(ct, recipe=rt) == man_t
    assert _layout(tpaths(shapes_t)) == _layout(jpaths(shapes_j))
    assert tp.recipe_plan_bytes(ct, rt) == jp.recipe_plan_bytes(cj, rj)
    if recipe == "mixed":                # the skipped site plans no task
        assert all(not t["path"].endswith(".attn.o")
                   for b in man_t["buckets"] for t in b["tasks"])
    if cj.family == "hybrid":
        assert len(man_t["site_lora"]) == (6 if recipe == "mixed" else 7)


def test_manifest_legacy_form_and_unported_arguments():
    cfg = tc.get_smoke_config("qwen3-1.7b")
    q = TQSpec(bits=4, group_size=16, rank=8)
    assert tp.quantization_manifest(cfg, "cloq", q) == \
        tp.quantization_manifest(cfg, recipe=tr.QuantRecipe.single("cloq",
                                                                   q))
    with pytest.raises(ValueError, match="not both"):
        tp.quantization_manifest(cfg, "cloq",
                                 recipe=tr.QuantRecipe.single("cloq", q))
    # a mesh without a model axis plans every bucket replicated; a cost
    # model must be one (or its calibration); the sharded manifest is held
    # against JAX's in tests/test_torch_distributed.py
    assert tp.quantization_manifest(cfg, recipe=tr.QuantRecipe(),
                                    mesh=object()) == \
        tp.quantization_manifest(cfg, recipe=tr.QuantRecipe())
    with pytest.raises(TypeError, match="CostModel"):
        tp.quantization_manifest(cfg, recipe=tr.QuantRecipe(),
                                 cost_model=object())
    _, man = tp.quantized_param_shapes(cfg, recipe=tr.QuantRecipe(),
                                       mesh=object(), with_manifest=True)
    assert man == tp.quantization_manifest(cfg, recipe=tr.QuantRecipe())


def _site_bytes_of(params: dict, cfg, recipe) -> int:
    """Serialized bytes of a real quantized tree's sites: each quantized
    linear's leaves (a shared one's per-site adapter stacks too), a
    skipped one's dense ``w``."""
    eparams = tp.to_eager_params(params, cfg)
    total = 0
    for path, site in recipe.resolve(
            tp.quantizable_linear_paths(tp._abstract_eager_shapes(cfg))
    ).items():
        leaves = dict(get_path(eparams, path))
        if path.startswith("shared.block.") and not site.skip:
            name = path[len("shared.block."):].replace(".", "_")
            leaves.update(params["shared"]["site_lora"][name])
        keys = ("w",) if site.skip else _QUANT_LEAVES
        total += sum(v.numel() * v.element_size() for k, v in leaves.items()
                     if k in keys)
    return total


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b"])
def test_abstract_plan_is_a_real_quantize(arch):
    """A real ``quantize_model`` of the smoke model under the mixed recipe
    (group 16 for the MoE smoke model's d_ff of 32) gives the tree of
    ``quantized_param_shapes`` exactly, and its sites' bytes are
    ``recipe_plan_bytes``."""
    from repro_torch.data import DataConfig, TokenStream
    cfg = tc.get_smoke_config(arch)
    recipe = tr.QuantRecipe(rules=MIXED_RULES, method="cloq",
                            qspec=TQSpec(bits=4, group_size=16, rank=8))
    params = tt.init_params(cfg, seed=0, device="cpu")
    ds = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                                seed=1))
    qp, qcfg, _ = tp.quantize_model(params, cfg, [ds.next_batch()],
                                    recipe=recipe)
    assert _layout(tpaths(qp)) == \
        _layout(tpaths(tp.quantized_param_shapes(cfg, recipe=recipe)))
    assert _site_bytes_of(qp, cfg, recipe) == tp.recipe_plan_bytes(cfg,
                                                                   recipe)


def test_checkpoint_manifest_read_by_jax(tmp_path):
    """``save_tree(manifest=)`` and ``CheckpointManager.maybe_save(...,
    manifest=)`` put the manifest in ``meta.json`` where the JAX reader
    finds it, and the port reads JAX's; ``load_plan`` on such a
    ``meta.json`` gives the default recipe in both packages (the
    reference's defect: the manifest sits under ``bucket_manifest``)."""
    cfg = tc.get_smoke_config("zamba2-7b")
    recipe = tr.QuantRecipe(rules=MIXED_RULES, method="cloq",
                            qspec=TQSpec(bits=4, group_size=16, rank=8))
    man = tp.quantization_manifest(cfg, recipe=recipe)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_tree(tree, str(tmp_path / "p"), 3, {"data": {"step": 1}},
              manifest=man)
    got, meta = jax_restore(str(tmp_path / "p"))
    assert meta[MANIFEST_KEY] == man and meta["data"] == {"step": 1}
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2, every=1)
    for step in (1, 2):
        mgr.maybe_save(step, tree, {"step": step}, manifest=man)
    mgr.wait()
    assert jax_restore(str(tmp_path / "m"))[1][MANIFEST_KEY] == man
    jax_save({"a": np.ones(3, np.float32)}, str(tmp_path / "j"), 5,
             manifest=man)
    assert restore_tree(str(tmp_path / "j"))[1][MANIFEST_KEY] == man
    meta_path = str(tmp_path / "p" / "step_00000003" / "meta.json")
    plan_t, plan_j = tr.load_plan(meta_path), jr.load_plan(meta_path)
    assert plan_t.to_dict() == plan_j.to_dict() and not plan_t.rules
    assert tr.plan_fingerprint(meta[MANIFEST_KEY]) == \
        jr.plan_fingerprint(man)
