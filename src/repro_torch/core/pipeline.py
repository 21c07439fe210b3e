"""End-to-end model quantization + LoRA initialization (sequential engine).

PyTorch twin of the sequential engine of ``repro.core.pipeline``.
``quantize_model`` converts a dense param tree into the paper's deployment
form: every block linear replaced by {qcodes, scales, zeros, lora_a,
lora_b}, the base quantized by MagR -> OPTQ against calibration Grams and
the adapters initialized by CLoQ's closed form.

Calibration runs the model with per-layer params (``scan_layers=False``)
so the name-scope capture hooks key every Gram by its linear's path.

Ported so far: method ``cloq`` with ``engine="sequential"``.  The batched
engine, the other methods, the health guards, fault hooks, journal and
obs spans are later slices of the port (``ROADMAP.md``); asking for them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterable

import torch

from repro_torch.core.cloq import cloq_init, regularize_gram
from repro_torch.core.magr import magr_alpha, magr_preprocess
from repro_torch.core.optq import optq_quantize
from repro_torch.core.quantizer import QuantConfig, pack_codes
from repro_torch.core.recipe import QuantRecipe, SiteSpec
from repro_torch.models.modules import QSpec
from repro_torch.models.transformer import (ModelConfig, forward,
                                            layer_params, n_stacked,
                                            stack_layers)
from repro_torch.utils import (GramStore, capture_grams, get_path, set_path,
                               tree_paths)

Tensor = torch.Tensor

# param paths NOT quantized even though they hold a 2-D "w"
_SKIP_SUFFIXES = ("embed.w", "head.w", "router.w")

_PORTED_METHODS = ("cloq",)
_NOT_PORTED = "is not ported to repro_torch yet (see ROADMAP.md)"


def qspec_to_qcfg(q: QSpec) -> QuantConfig:
    return QuantConfig(bits=q.bits, group_size=q.group_size)


def to_eager_params(params: dict, cfg: ModelConfig) -> dict:
    """Unstack scan-stacked block params into per-layer dicts (views)."""
    if not cfg.scan_layers:
        return params
    out = dict(params)
    blocks = params["blocks"]
    out["blocks"] = {str(i): layer_params(blocks, i)
                     for i in range(n_stacked(blocks))}
    return out


def to_scan_params(params: dict, cfg: ModelConfig) -> dict:
    out = dict(params)
    blocks = params.get("blocks")
    if isinstance(blocks, dict) and blocks and all(k.isdigit()
                                                   for k in blocks):
        out["blocks"] = stack_layers([blocks[k]
                                      for k in sorted(blocks, key=int)])
    return out


def quantizable_linear_paths(params: dict) -> list[str]:
    """Paths of linear subtrees (ending at the dict holding 'w') that are
    quantization targets: 2-D or stacked-3-D weights inside blocks."""
    out = []
    for path, leaf in tree_paths(params).items():
        if not path.endswith(".w"):
            continue
        if any(path.endswith(sfx) for sfx in _SKIP_SUFFIXES):
            continue
        if "conv" in path.rsplit(".", 2)[-2]:
            continue
        if not hasattr(leaf, "dim") or leaf.dim() not in (2, 3):
            continue
        if not any(seg in path for seg in ("blocks.", "shared.", "cross.")):
            continue
        out.append(path[: -len(".w")])
    return sorted(out)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_calibration(params: dict, cfg: ModelConfig,
                    batches: Iterable[dict]) -> GramStore:
    """Per-layer forward passes accumulating per-linear Grams (f32, on the
    params' device).  A batch whose Grams come out non-finite is skipped
    with a warning; when every batch is skipped it raises."""
    eager_cfg = dataclasses.replace(cfg, scan_layers=False, quant=None)
    eparams = to_eager_params(params, cfg)
    device = params["embed"]["w"].device
    store = GramStore()
    n_in = n_used = 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            n_in += 1
            scratch = GramStore()
            with capture_grams(scratch):
                forward(eparams, eager_cfg, _to_device(batch, device))
            if not scratch.all_finite():
                warnings.warn(f"calibration batch {i} produced non-finite "
                              "activations — batch skipped", RuntimeWarning,
                              stacklevel=2)
                continue
            store.merge(scratch)
            n_used += 1
    if n_in and not n_used:
        raise RuntimeError(
            f"calibration produced a zero-sample GramStore: all {n_in} "
            "batches were skipped (non-finite activations)")
    return store


def _quantize_one(W: Tensor, H: Tensor | None, qspec: QSpec,
                  method: str) -> dict:
    """Quantize one (m, n) weight with MagR -> OPTQ -> CLoQ.  Returns the
    new leaves {qcodes, scales, zeros, lora_a, lora_b} (f32 factors)."""
    if method not in _PORTED_METHODS:
        raise NotImplementedError(f"method {method!r} {_NOT_PORTED}")
    if H is None:
        raise ValueError("cloq needs calibration Grams")
    qcfg = qspec_to_qcfg(qspec)
    m = W.shape[0]
    W = W.float()
    H = H.float()
    Wp = (magr_preprocess(W, H, alpha=magr_alpha(H, m), iters=20)
          if qspec.bits <= 4 else W)
    Qd, Qc, s, z = optq_quantize(Wp, H, qcfg)
    # one lambda_frac governs OPTQ's damping and CLoQ's regularization
    A, B = cloq_init(regularize_gram(H, qcfg.lambda_frac), W - Qd,
                     qspec.rank, qspec.split)
    return {"qcodes": pack_codes(Qc, qspec.bits), "scales": s, "zeros": z,
            "lora_a": A, "lora_b": B}


def _cast_for_model(leaves: dict, dtype) -> dict:
    return {k: (v.to(dtype) if k in ("lora_a", "lora_b") else v)
            for k, v in leaves.items()}


def _quantize_model_sequential(eparams: dict, store: GramStore,
                               sites: dict[str, SiteSpec], cfg: ModelConfig,
                               new_params: dict,
                               progress: Callable[[str], None] | None
                               ) -> None:
    for i, lin_path in enumerate(quantizable_linear_paths(eparams)):
        site = sites[lin_path]
        if site.skip:
            if progress:
                progress(f"[{i}] {lin_path} skipped (left dense)")
            continue
        qspec, method = site.qspec, site.method
        lin = dict(get_path(eparams, lin_path))
        W = lin.pop("w")
        if W.dim() != 2 or lin_path.startswith(("shared.", "cross.")):
            raise NotImplementedError(
                f"{lin_path}: stacked-expert and weight-shared sites "
                f"{_NOT_PORTED}")
        if progress:
            progress(f"[{i}] {lin_path} {tuple(W.shape)} "
                     f"{method}/{qspec.bits}b/r{qspec.rank}")
        with torch.no_grad():
            newlin = _quantize_one(W, store.grams.get(lin_path), qspec,
                                   method)
        keep = dict(lin)                          # bias etc.
        keep.update(_cast_for_model(newlin, cfg.dtype))
        set_path(new_params, lin_path, keep)


def _check_scan_uniform(sites: dict[str, SiteSpec], cfg: ModelConfig) -> None:
    """Scan-stacked blocks are re-stacked after quantization, which needs
    one leaf structure for every layer: a layer-uniform recipe."""
    if not cfg.scan_layers:
        return
    groups: dict[str, set[SiteSpec]] = {}
    for p, s in sites.items():
        segs = p.split(".")
        if segs[0] == "blocks" and len(segs) > 1 and segs[1].isdigit():
            groups.setdefault(".".join(segs[2:]), set()).add(s)
    for rest, specs in sorted(groups.items()):
        if len(specs) > 1:
            raise ValueError(
                f"recipe resolves layers of the scan-stacked blocks to "
                f"{len(specs)} different specs at blocks.<i>.{rest}; scan "
                "stacking needs layer-uniform rules — use a config with "
                "scan_layers=False for depth-dependent plans")


def _coerce_recipe(recipe: QuantRecipe | None, method: str | None,
                   qspec: QSpec | None, cfg: ModelConfig) -> QuantRecipe:
    if recipe is not None:
        if method is not None or qspec is not None:
            raise ValueError("quantize_model: pass either recipe= or the "
                             "(method=, qspec=) pair, not both")
        return recipe
    return QuantRecipe.single(method or "cloq", qspec or cfg.quant or QSpec())


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree


def quantize_model(params: dict, cfg: ModelConfig, calib_batches: list[dict],
                   *, recipe: QuantRecipe | None = None,
                   method: str | None = None, qspec: QSpec | None = None,
                   seed: int = 0, engine: str = "sequential",
                   progress: Callable[[str], None] | None = None):
    """Quantize all block linears of ``params`` on their device.

    ``recipe`` declares per-site plans (first-match-wins rules over eager
    param paths, see :mod:`repro_torch.core.recipe`); the ``(method,
    qspec)`` pair is the zero-rule recipe.  ``seed`` is accepted for
    signature parity (cloq draws no random numbers).

    Returns (new_params in the input (scan/eager) layout, new_cfg with
    ``quant=`` set to the recipe's default qspec, gram_store).  Skipped
    sites keep their dense ``w`` leaf."""
    if engine != "sequential":
        raise NotImplementedError(f"engine {engine!r} {_NOT_PORTED}; use "
                                  "engine='sequential'")
    recipe = _coerce_recipe(recipe, method, qspec, cfg)
    eparams = to_eager_params(params, cfg)
    sites = recipe.resolve(quantizable_linear_paths(eparams))
    for path, site in sites.items():
        if not site.skip and site.method not in _PORTED_METHODS:
            raise NotImplementedError(
                f"{path}: method {site.method!r} {_NOT_PORTED}")
    _check_scan_uniform(sites, cfg)
    store = run_calibration(eparams, dataclasses.replace(cfg,
                                                         scan_layers=False),
                            calib_batches)
    new_params = _tree_copy(eparams)
    _quantize_model_sequential(eparams, store, sites, cfg, new_params,
                               progress)
    new_cfg = dataclasses.replace(cfg, quant=recipe.qspec)
    if cfg.scan_layers:
        new_params = to_scan_params(new_params, cfg)
    return new_params, new_cfg, store
