"""End-to-end model quantization + LoRA initialization.

PyTorch twin of ``repro.core.pipeline`` for every model family on one
device.
``quantize_model`` converts a dense param tree into the paper's deployment
form: every block linear replaced by {qcodes, scales, zeros, lora_a,
lora_b} ({qcodes, absmax, ...} for NF4 ``qlora``), the base quantized by
the site's method (CLoQ: MagR -> OPTQ against calibration Grams, adapters
by CLoQ's closed form; or the baselines GPTQ-LoRA, LoftQ, QLoRA, RTN).

Calibration runs the model with per-layer params (``scan_layers=False``)
so the name-scope capture hooks key every Gram by its linear's path; a
stacked MoE expert site ``(E, m, n)`` gets one Gram an expert,
``(E, m, m)``, and each expert slice is quantized as a site of its own
(its health record keyed ``path[e]``).  An expert the health ladder leaves
dense leaves its whole stacked site dense: the site is one leaf tree.

A hybrid model's weight-shared block (``shared.block.<mod>.<lin>``) is
quantized once, against the pooled Gram of all its call sites (the sum of
``sites.<s>.shared.<mod>.<lin>``), and keeps no adapter of its own; each
site gets its own CLoQ pair, one Theorem-3.1 solve against the site's
Gram with the shared residual ``W - Q`` fixed
(:func:`repro_torch.core.cloq.cloq_site_lora`), stacked into
``shared.site_lora.<mod>_<lin>``.  Other methods give every site the
base's own adapter pair.  A non-finite site pair walks
``health.heal_site_lora``.  Sites are ordered by their number (the JAX
twin sorts their keys as strings, which puts ``sites.10`` before
``sites.2`` from 11 sites on).

An enc-dec model's cross-attention linears ``cross.<i>.xattn.<name>`` are
sites like any other; their Grams are captured under the decoder layer's
scope, ``dec_blocks.<i>.cross.<name>`` (:func:`_scope_for`), and ``k``/``v``
see the encoder output's rows.

Engines
-------
``engine="batched"`` (default) is :mod:`repro_torch.core.batched`: the
sites are grouped into buckets of one shape and spec, and each bucket runs
as one stacked call.  ``engine="sequential"`` quantizes one linear at a
time; it is the parity oracle.  Both draw each site's random LoRA init
from the site's own generator (``batched.task_key(seed, site index)``, an
expert's from ``(seed, site index, expert)``) and read every Gram through
the same fault hooks (:func:`_site_gram`, :func:`_expert_grams`), and the
health guards (``HealthPolicy()``, on unless turned off) check every site
and heal a failing one through the same single-site core in both, so a
healed site is bit-identical across engines.  ``journal_dir=`` makes a
batched run resumable at bucket boundaries.

Bit allocation (:func:`allocate_plan`, :func:`allocate_recipe`) derives
the recipe from a byte budget through :mod:`repro_torch.core.allocate`.
The abstract functions (:func:`quantization_manifest`,
:func:`recipe_plan_bytes`, :func:`quantized_param_shapes`) plan from the
config's shapes alone, on the meta device: no weights, no calibration.

``mesh=`` (batched engine; every rank of the mesh calls ``quantize_model``
with the same params and calibration) runs each bucket column-sharded over
``shard_axis`` (:mod:`repro_torch.core.batched`): a sharded site's leaves
are DTensors of the rank's block, ``lora_a`` replicated
(``models.parallel.gather_tree`` makes a tree whole).  ``cost_model=``
chooses each bucket's path from predicted time
(:mod:`repro_torch.core.costmodel`).  ``compile_cache=`` names the
directory this process's kernel libraries are built into and loaded from
(:mod:`repro_torch.core.compile_cache`, ``kernels.build.use_cache``).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Iterable

import torch

from repro_torch.core import faults, health
from repro_torch.core.batched import (GRAM_METHODS, LayerTask,
                                      bucket_shards, make_spec, plan_buckets,
                                      plan_manifest, quantize_layer_batch,
                                      quantize_single, task_key)
from repro_torch.core.cloq import cloq_site_lora
from repro_torch.core.quantizer import dequantize_int, unpack_codes
from repro_torch.core.recipe import QuantRecipe, SiteSpec
from repro_torch.kernels import build
from repro_torch.models import parallel
from repro_torch.models.modules import QSpec
from repro_torch.models.transformer import (ModelConfig, forward,
                                            layer_params, n_stacked,
                                            stack_layers)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import (ActivationLog, GramStore, capture_grams,
                               get_path, set_path, tree_paths)

Tensor = torch.Tensor

# param paths NOT quantized even though they hold a 2-D "w"
_SKIP_SUFFIXES = ("embed.w", "head.w", "router.w")

# containers stacked over layers when scan_layers, with their layer counts
_STACK_KEYS = {"blocks": "n_layers", "enc_blocks": "n_enc_layers",
               "dec_blocks": "n_layers", "cross": "n_layers"}


def to_eager_params(params: dict, cfg: ModelConfig) -> dict:
    """Unstack scan-stacked containers into per-layer dicts (views)."""
    if not cfg.scan_layers:
        return params
    out = dict(params)
    for key in _STACK_KEYS:
        if key in params:
            out[key] = {str(i): layer_params(params[key], i)
                        for i in range(n_stacked(params[key]))}
    return out


def to_scan_params(params: dict, cfg: ModelConfig) -> dict:
    """Stack per-layer containers (``"0"``, ``"1"``, … keys) over layers."""
    out = dict(params)
    for key in _STACK_KEYS:
        layers = params.get(key)
        if isinstance(layers, dict) and layers and all(k.isdigit()
                                                       for k in layers):
            out[key] = stack_layers([layers[k]
                                     for k in sorted(layers, key=int)])
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
                    batches: Iterable[dict], *,
                    report: "health.HealthReport | None" = None
                    ) -> GramStore:
    """Per-layer forward passes accumulating per-linear Grams (f32, on the
    params' device).

    Each batch's activations are recorded (:class:`repro_torch.utils.
    ActivationLog`) and its Grams added to the store only when every one
    of them is finite, as a per-batch scratch store would be merged, but
    one Gram at a time: a MoE model's expert Grams (OLMoE-1B-7B: 39.7 GB
    at 16 layers) are held once, not twice.  A batch with non-finite
    activations is skipped and logged (``report.event`` and a
    ``RuntimeWarning``), a dropped one is logged.  Raises when batches were
    given but every one was skipped or dropped."""
    eager_cfg = dataclasses.replace(cfg, scan_layers=False, quant=None)
    eparams = to_eager_params(params, cfg)
    device = params["embed"]["w"].device
    store = GramStore()
    n_in = n_used = 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            n_in += 1
            batch = faults.corrupt_batch(i, batch)    # calib_nan/calib_drop
            if batch is faults.DROPPED:
                obs_metrics.counter(obs_names.CALIB_BATCHES_SKIPPED).inc()
                if report is not None:
                    report.event(f"calibration batch {i} dropped")
                continue
            log = ActivationLog()
            with capture_grams(log):
                forward(eparams, eager_cfg, _to_device(batch, device))
            faults.poison_grams(i, log)               # calib_nan (post)
            if not log.grams_finite():
                obs_metrics.counter(obs_names.CALIB_BATCHES_SKIPPED).inc()
                msg = (f"calibration batch {i} produced non-finite "
                       "activations — batch skipped")
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                if report is not None:
                    report.event(msg)
                continue
            log.merge_into(store)
            del log
            n_used += 1
            obs_metrics.counter(obs_names.CALIB_BATCHES_USED).inc()
    if n_in and not n_used:
        raise RuntimeError(
            f"calibration produced a zero-sample GramStore: all {n_in} "
            "batches were skipped (non-finite activations) or dropped — "
            "fix the calibration data, or use a data-free method")
    return store


def _scope_for(lin_path: str) -> str:
    """The capture scope of a param path: ``shared.block.attn.q`` is
    recorded as ``sites.<s>.shared.attn.q`` (this returns the part after
    ``sites.<s>.``), ``cross.<i>.xattn.q`` as ``dec_blocks.<i>.cross.q``."""
    if lin_path.startswith("shared.block."):
        return "shared." + lin_path[len("shared.block."):]
    if lin_path.startswith("cross."):
        _, idx, _, name = lin_path.split(".")
        return f"dec_blocks.{idx}.cross.{name}"
    return lin_path


def _shared_site_keys(store: GramStore, lin_path: str) -> list[str]:
    """The site Gram keys ``sites.<s>.shared.<mod>.<lin>`` of a shared
    linear, in site order."""
    suffix = "." + _scope_for(lin_path)
    return sorted((k for k in store.grams
                   if k.startswith("sites.") and k.endswith(suffix)),
                  key=lambda k: int(k.split(".")[1]))


def _shared_site_grams(store: GramStore, lin_path: str):
    """(the site Gram keys in site order, their pooled sum through the
    fault hook at ``lin_path``)."""
    site_paths = _shared_site_keys(store, lin_path)
    pooled = None
    for sp in site_paths:
        g = store.grams[sp]
        pooled = g.clone() if pooled is None else pooled + g
    return site_paths, faults.corrupt_gram(lin_path, pooled)


def _shared_base_dequant(newlin: dict, m: int, qspec: QSpec) -> Tensor:
    """The shared base dequantized once (f32): every site's residual."""
    codes = unpack_codes(newlin["qcodes"], qspec.bits, m)
    return dequantize_int(codes, newlin["scales"], newlin["zeros"],
                          qspec.group_size)


def _set_shared_sites(new_params: dict, store: GramStore, path: str,
                      W: Tensor, newlin: dict, site: SiteSpec,
                      site_paths: list[str], cfg: ModelConfig, *, policy,
                      report, mesh=None, shard_axis: str = "model") -> None:
    """Pop the shared base's own adapter pair from ``newlin`` and set the
    stacked per-site adapters of the linear at ``path``.  CLoQ: one solve
    a site against its Gram (read through the fault hook at its key), a
    non-finite pair healed by ``health.heal_site_lora`` when the guards
    are on; other methods: the base's pair at every site.  With ``mesh``
    the solves are column-sharded when ``n`` divides the axis (the
    planner's gate), ``Bs`` coming back sharded."""
    A0, B0 = newlin.pop("lora_a"), newlin.pop("lora_b")
    if not site_paths:
        return
    S, qspec = len(site_paths), site.qspec
    if site.method != "cloq":
        As = parallel.stack_sharded([A0] * S)
        Bs = parallel.stack_sharded([B0] * S)
    else:
        # the base's leaves made whole (a collective under a mesh)
        dW = W.float() - _shared_base_dequant(parallel.gather_tree(newlin),
                                              W.shape[0], qspec)
        Hs_raw = [faults.corrupt_gram(sp, store.grams[sp])
                  for sp in site_paths]
        site_mesh = mesh if bucket_shards(dW.shape[1], site.method, mesh,
                                          shard_axis) > 1 else None
        As, Bs = cloq_site_lora(Hs_raw, dW, qspec.rank, qspec.split,
                                mesh=site_mesh, axis=shard_axis)
        guarded = policy is not None and policy.enabled
        if guarded:
            As, Bs = _heal_site_pairs(As, Bs, Hs_raw, dW, qspec, policy,
                                      report, path, site_paths, site_mesh,
                                      shard_axis)
    rest = path[len("shared.block."):].replace(".", "_")
    set_path(new_params, f"shared.site_lora.{rest}",
             {"lora_a": As.to(cfg.dtype).contiguous(),
              "lora_b": Bs.to(cfg.dtype).contiguous()})


def _heal_site_pairs(As, Bs, Hs_raw, dW: Tensor, qspec: QSpec, policy,
                     report, path: str, site_paths: list[str], mesh,
                     axis: str):
    """Every non-finite site pair through ``health.heal_site_lora``.  Under
    a mesh the flags are summed over the ranks (a rank sees its block of
    ``Bs`` only), every rank heals the same sites whole, and keeps its
    block."""
    A_l, B_l = parallel.local_of(As), parallel.local_of(Bs)
    bad = torch.stack([(~torch.isfinite(A_l[s])).any() |
                       (~torch.isfinite(B_l[s])).any()
                       for s in range(len(site_paths))]).float()
    if mesh is not None:
        bad = parallel.all_reduce_sum(bad, parallel.axis_group(mesh, axis))
    bad = [s for s, b in enumerate(bad.tolist()) if b]
    if not bad:
        return As, Bs
    A_l, B_l = A_l.clone(), B_l.clone()
    for s in bad:
        A, B = health.heal_site_lora(Hs_raw[s], dW, qspec.rank, qspec.split,
                                     policy, report, path, site_paths[s])
        A_l[s] = A
        B_l[s] = (B if mesh is None
                  else parallel.local_slice(B, (axis, None), mesh))
    if mesh is None:
        return A_l, B_l
    return (parallel.distribute_local(A_l, (None, None, None), mesh),
            parallel.distribute_local(B_l, (None, axis, None), mesh))


def _site_gram(store: GramStore, path: str) -> Tensor | None:
    """A site's Gram, read at its capture scope (:func:`_scope_for`),
    through the fault-injection hook keyed by its param path
    (:func:`repro_torch.core.faults.corrupt_gram`): both engines read every
    Gram here, so an armed ``gram_*`` injection corrupts the same site in
    each."""
    return faults.corrupt_gram(path, store.grams.get(_scope_for(path)))


def _expert_grams(store: GramStore, path: str,
                  n_experts: int) -> list[Tensor | None]:
    """The ``(m, m)`` Gram of each expert of a stacked site, through the
    fault hook: an injection matching ``path`` corrupts every expert's (as
    in the JAX twin), else one matching the expert's own key ``path[e]``
    (``HealthReport.site_key``) corrupts that expert's alone."""
    raw = store.grams.get(path)
    if raw is None:
        return [None] * n_experts
    H = _site_gram(store, path)
    if H is not raw:
        return list(H)
    return [faults.corrupt_gram(health.HealthReport.site_key(path, e), raw[e])
            for e in range(n_experts)]


def _quantize_one(W: Tensor, H: Tensor | None, qspec: QSpec, method: str,
                  key: int) -> dict:
    """Quantize one (m, n) weight with ``method``.  Returns the new leaves
    (f32 factors); ``key`` seeds the random LoRA init of gptq/qlora/rtn."""
    if method in ("cloq", "gptq") and H is None:
        raise ValueError(f"{method} needs calibration Grams")
    spec = make_spec(W.shape[0], W.shape[1], qspec, method, H is not None)
    return quantize_single(W, H, key, spec)


def _cast_for_model(leaves: dict, dtype) -> dict:
    return {k: (v.to(dtype) if k in ("lora_a", "lora_b") else v)
            for k, v in leaves.items()}


def _stacked_dense_event(report, path: str) -> None:
    """The JAX twin's event for an expert left dense by the ladder."""
    if report is not None:
        report.event(f"{path}: expert degraded to dense — whole stacked "
                     "site left dense")


def _stack_experts(outs: list[dict]) -> dict:
    return {k: parallel.stack_sharded([o[k] for o in outs]) for k in outs[0]}


def _quantize_model_sequential(eparams: dict, store: GramStore,
                               sites: dict[str, SiteSpec], seed: int,
                               cfg: ModelConfig, new_params: dict,
                               progress: Callable[[str], None] | None, *,
                               policy=None, report=None, journal=None,
                               should_stop=None) -> None:
    assert journal is None, "quantize_model rejects journal+sequential"
    guarded = policy is not None and policy.enabled
    if guarded and report is None:
        report = health.HealthReport()

    def guard(W, H, leaves, key, site, path, expert=None):
        """Per-layer check and ladder: the batched engine's criterion,
        oracle and (W, H, key, spec)."""
        if not guarded:
            return leaves
        spec = make_spec(W.shape[0], W.shape[1], site.qspec, site.method,
                         H is not None)
        report.checked += 1
        obs_metrics.counter(obs_names.HEALTH_CHECKED).inc()
        if health.check_single(W, leaves, spec, policy):
            return leaves
        return health.heal_task(W, H, key, spec, policy, report, path,
                                expert)

    for i, lin_path in enumerate(quantizable_linear_paths(eparams)):
        site = sites[lin_path]
        if site.skip:
            if progress:
                progress(f"[{i}] {lin_path} skipped (left dense)")
            continue
        qspec, method = site.qspec, site.method
        lin = dict(get_path(eparams, lin_path))
        W = lin.pop("w")
        if progress:
            progress(f"[{i}] {lin_path} {tuple(W.shape)} "
                     f"{method}/{qspec.bits}b/r{qspec.rank}")
        # one key a quantizable path (an expert's from it), skipped sites
        # included, so keys do not depend on the recipe's skip rules and
        # match the batched engine
        with torch.no_grad():
            if W.dim() == 3:                   # stacked MoE experts
                Hs = _expert_grams(store, lin_path, W.shape[0])
                outs = []
                for e in range(W.shape[0]):
                    key = task_key(seed, i, e)
                    lv = _quantize_one(W[e], Hs[e], qspec, method, key)
                    outs.append(guard(W[e], Hs[e], lv, key, site, lin_path,
                                      e))
                if any(o is None for o in outs):
                    _stacked_dense_event(report, lin_path)
                    continue
                newlin = _stack_experts(outs)
            elif lin_path.startswith("shared.block."):
                # the pooled Gram for the shared base, each site's own for
                # its adapters
                key = task_key(seed, i)
                site_paths, H = _shared_site_grams(store, lin_path)
                newlin = _quantize_one(W, H, qspec, method, key)
                newlin = guard(W, H, newlin, key, site, lin_path)
                if newlin is not None:
                    _set_shared_sites(new_params, store, lin_path, W, newlin,
                                      site, site_paths, cfg, policy=policy,
                                      report=report)
            else:
                key = task_key(seed, i)
                H = _site_gram(store, lin_path)
                newlin = _quantize_one(W, H, qspec, method, key)
                newlin = guard(W, H, newlin, key, site, lin_path)
        if newlin is None:
            continue                           # degraded to dense: keep w
        keep = dict(lin)                          # bias etc.
        keep.update(_cast_for_model(newlin, cfg.dtype))
        set_path(new_params, lin_path, keep)


def _gather_tasks(eparams: dict, store: GramStore,
                  sites: dict[str, SiteSpec], seed: int):
    """Every non-skipped site as :class:`LayerTask`s carrying its resolved
    spec, keyed like the sequential loop (skipped sites take a key but give
    no task): one task a 2-D site (a shared linear's with the pooled Gram),
    one an expert of a stacked site.  Returns (tasks, [(path, other leaves,
    its task indices, a shared linear's site Gram keys or None)] in task
    order)."""
    tasks: list[LayerTask] = []
    groups: list[tuple] = []
    for i, lin_path in enumerate(quantizable_linear_paths(eparams)):
        site = sites[lin_path]
        if site.skip:
            continue
        lin = dict(get_path(eparams, lin_path))
        W = lin.pop("w")
        shared = None
        if W.dim() == 3:            # stacked MoE experts: a natural bucket
            Hs = _expert_grams(store, lin_path, W.shape[0])
            idxs = list(range(len(tasks), len(tasks) + W.shape[0]))
            tasks.extend(LayerTask(lin_path, e, W[e], Hs[e],
                                   task_key(seed, i, e), site=site)
                         for e in range(W.shape[0]))
        else:
            if lin_path.startswith("shared.block."):
                shared, H = _shared_site_grams(store, lin_path)
            else:
                H = _site_gram(store, lin_path)
            idxs = [len(tasks)]
            tasks.append(LayerTask(lin_path, None, W, H, task_key(seed, i),
                                   site=site))
        groups.append((lin_path, lin, idxs, shared))
    return tasks, groups


def _quantize_model_batched(eparams: dict, store: GramStore,
                            sites: dict[str, SiteSpec], seed: int,
                            cfg: ModelConfig, new_params: dict,
                            progress: Callable[[str], None] | None, *,
                            policy=None, report=None, journal=None,
                            should_stop=None, mesh=None,
                            shard_axis: str = "model",
                            cost_model=None) -> None:
    tasks, groups = _gather_tasks(eparams, store, sites, seed)
    with torch.no_grad():
        results = quantize_layer_batch(tasks, progress=progress,
                                       mesh=mesh, axis=shard_axis,
                                       policy=policy, report=report,
                                       journal=journal,
                                       should_stop=should_stop,
                                       cost_model=cost_model)
    for path, lin, idxs, shared in groups:
        outs = [results[i] for i in idxs]
        for i in idxs:                 # a finished chunk's leaves are freed
            results[i] = None          # once all of its sites are stacked
        if any(o is None for o in outs):
            if tasks[idxs[0]].expert is not None:
                _stacked_dense_event(report, path)
            continue                          # degraded to dense: keep w
        res = (outs[0] if tasks[idxs[0]].expert is None
               else _stack_experts(outs))
        if shared is not None:
            res = dict(res)
            with torch.no_grad():
                _set_shared_sites(new_params, store, path, tasks[idxs[0]].W,
                                  res, sites[path], shared, cfg,
                                  policy=policy, report=report, mesh=mesh,
                                  shard_axis=shard_axis)
        keep = dict(lin)                          # bias etc.
        keep.update(_cast_for_model(res, cfg.dtype))
        set_path(new_params, path, keep)


_ENGINES = {"batched": _quantize_model_batched,
            "sequential": _quantize_model_sequential}


def _check_scan_uniform(sites: dict[str, SiteSpec], cfg: ModelConfig) -> None:
    """Scan-stacked containers are re-stacked after quantization, which
    needs one leaf structure for every layer of a container: a recipe
    layer-uniform within each."""
    if not cfg.scan_layers:
        return
    groups: dict[tuple[str, str], set[SiteSpec]] = {}
    for p, s in sites.items():
        segs = p.split(".")
        if segs[0] in _STACK_KEYS and len(segs) > 1 and segs[1].isdigit():
            groups.setdefault((segs[0], ".".join(segs[2:])), set()).add(s)
    for (container, rest), specs in sorted(groups.items()):
        if len(specs) > 1:
            raise ValueError(
                f"recipe resolves layers of the scan-stacked container "
                f"{container!r} to {len(specs)} different specs at "
                f"{container}.<i>.{rest}; scan stacking needs layer-uniform "
                "rules — use a config with scan_layers=False for "
                "depth-dependent plans")


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
                   seed: int = 0, engine: str = "batched",
                   progress: Callable[[str], None] | None = None,
                   mesh=None, shard_axis: str = "model",
                   policy: "health.HealthPolicy | None" = None,
                   report: "health.HealthReport | None" = None,
                   journal_dir: str | None = None,
                   should_stop: Callable[[], bool] | None = None,
                   cost_model=None, compile_cache=None):
    """Quantize all block linears of ``params`` on their device.

    ``recipe`` declares per-site plans (first-match-wins rules over eager
    param paths, see :mod:`repro_torch.core.recipe`); the ``(method,
    qspec)`` pair is the zero-rule recipe.  ``seed`` seeds each site's
    random LoRA init (gptq, qlora, rtn).  ``engine`` is ``"batched"``
    (default) or ``"sequential"``; both give the same leaves up to OPTQ
    near-ties.

    ``policy`` (:class:`repro_torch.core.health.HealthPolicy`) is on by
    default: every site is checked and a failing one walks the degradation
    ladder instead of landing as NaN leaves; ``HealthPolicy(enabled=False)``
    turns it off.  ``report`` collects the ladder records and run events
    (one is made when omitted).  ``journal_dir`` (batched engine only):
    every finished bucket is committed to a
    :class:`repro_torch.checkpoint.manager.QuantJournal` there, a rerun of
    the same plan restores the committed buckets bit-identical, and the
    report is saved as ``<journal_dir>/health.json``.  ``should_stop`` is
    polled at every bucket boundary; True raises
    :class:`repro_torch.core.health.QuantPreempted`.

    ``mesh`` (batched engine only; a ``DeviceMesh`` from
    :mod:`repro_torch.launch.mesh`, every rank calling with the same
    params, batches and seed) runs each bucket column-sharded over
    ``shard_axis``, buckets whose column count does not divide the axis
    replicated; a sharded site's leaves are DTensors of the rank's block,
    ``lora_a`` replicated.  ``cost_model`` (batched engine only; a
    :class:`repro_torch.core.costmodel.CostModel`, a calibration or its
    file) chooses each bucket's path from predicted time.
    ``compile_cache`` (a :class:`~repro_torch.core.compile_cache.
    CompileCache` or a directory) is where this process's kernel libraries
    are built and loaded (``kernels.build.use_cache``; on the CPU none is).

    Returns (new_params in the input (scan/eager) layout, new_cfg with
    ``quant=`` set to the recipe's default qspec, gram_store).  Skipped
    sites, and sites the ladder left dense, keep their dense ``w`` leaf."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}; options "
                         f"{tuple(_ENGINES)}")
    if compile_cache is not None:
        build.use_cache(compile_cache)
    if mesh is not None and engine != "batched":
        # fail before the (expensive) calibration pass, not after
        raise ValueError("mesh sharding is only supported by the batched "
                         "engine; use engine='batched' or drop mesh=")
    if cost_model is not None and engine != "batched":
        raise ValueError("cost_model= drives the batched engine's bucket "
                         "planner; use engine='batched' or drop it")
    if journal_dir is not None and engine != "batched":
        raise ValueError("journaled (resumable) quantization requires the "
                         "batched engine's bucket streaming; use "
                         "engine='batched' or drop journal_dir=")
    policy = health.HealthPolicy() if policy is None else policy
    report = health.HealthReport() if report is None else report
    journal = None
    if journal_dir is not None:
        from repro_torch.checkpoint.manager import QuantJournal
        journal = QuantJournal(journal_dir)
    recipe = _coerce_recipe(recipe, method, qspec, cfg)
    eparams = to_eager_params(params, cfg)
    sites = recipe.resolve(quantizable_linear_paths(eparams))
    _check_scan_uniform(sites, cfg)
    with obs_trace.span("quant.calibrate",
                        batches=len(calib_batches)) as sp:
        store = run_calibration(eparams, dataclasses.replace(
            cfg, scan_layers=False), calib_batches, report=report)
        sp.sync(store.grams)    # the Grams stay on the device
    new_params = _tree_copy(eparams)
    extra = ({"mesh": mesh, "shard_axis": shard_axis,
              "cost_model": cost_model} if engine == "batched" else {})
    with obs_trace.span("quant.model", engine=engine,
                        sites=len(sites)) as sp:
        _ENGINES[engine](eparams, store, sites, seed, cfg, new_params,
                         progress, policy=policy, report=report,
                         journal=journal, should_stop=should_stop, **extra)
        sp.sync(new_params)
    if journal_dir is not None:
        report.save(os.path.join(journal_dir, "health.json"))
    new_cfg = dataclasses.replace(cfg, quant=recipe.qspec)
    if cfg.scan_layers:
        new_params = to_scan_params(new_params, cfg)
    return new_params, new_cfg, store


# ---------------------------------------------------------------------------
# Calibrated bit allocation: derive the recipe from a byte budget
# (repro_torch.core.allocate: sensitivity sweep + budget solver).
# ---------------------------------------------------------------------------


def _allocation_meta(eparams: dict, store: GramStore
                     ) -> dict[str, tuple[int, int, int, int]]:
    """Each site's geometry for the allocator's byte accounting: ``{path:
    (m, n, experts, lora_sites)}``.  A stacked MoE weight multiplies
    everything by E; a weight-shared linear keeps one base and an adapter
    pair a recorded call site."""
    meta: dict[str, tuple[int, int, int, int]] = {}
    for lin_path in quantizable_linear_paths(eparams):
        W = get_path(eparams, lin_path)["w"]
        if W.dim() == 3:
            E, m, n = W.shape
            meta[lin_path] = (m, n, E, 1)
        elif lin_path.startswith("shared.block."):
            m, n = W.shape
            meta[lin_path] = (m, n, 1,
                              len(_shared_site_keys(store, lin_path)))
        else:
            m, n = W.shape
            meta[lin_path] = (m, n, 1, 1)
    return meta


def allocate_plan(params: dict, cfg: ModelConfig, calib, budget_bytes: int,
                  *, grid=None, qspec: QSpec | None = None,
                  include_skip: bool = False, seed: int = 0,
                  mesh=None, shard_axis: str = "model",
                  progress: Callable[[str], None] | None = None):
    """Solve for a mixed-precision plan under a byte budget.

    Stage 1 sweeps every quantization site over the candidate ``grid``
    (``(method, bits, rank)`` tuples; ``allocate.default_grid()`` when
    ``None``) through the batched engine's sweep, stage 2 picks one
    candidate a site (a scan-uniform group) minimizing the total proxy
    error with exact serialized bytes <= ``budget_bytes``.

    ``calib``: calibration batches, or a filled :class:`GramStore` to
    reuse.  ``qspec``: the base the candidates take ``group_size`` and
    ``split`` from (default ``cfg.quant``).  ``include_skip`` adds the
    leave-dense candidate.  ``mesh``: the sweep's divisible buckets run
    column-sharded over ``shard_axis`` (every rank calling with the same
    inputs; each gets the same plan).

    Returns a :class:`repro_torch.core.allocate.Allocation`; its
    ``.recipe`` is ready for ``quantize_model(recipe=...)``."""
    from repro_torch.core import allocate
    base = qspec or cfg.quant or QSpec()
    eparams = to_eager_params(params, cfg)
    store = (calib if isinstance(calib, GramStore) else run_calibration(
        eparams, dataclasses.replace(cfg, scan_layers=False), calib))
    # every site takes part in the sweep: a zero-rule recipe (the
    # candidates' specs replace it task by task)
    sites = QuantRecipe.single(base.method or "cloq", base).resolve(
        quantizable_linear_paths(eparams))
    tasks, _ = _gather_tasks(eparams, store, sites, seed)
    scan_containers = tuple(_STACK_KEYS) if cfg.scan_layers else ()
    return allocate.build_allocation(
        tasks, _allocation_meta(eparams, store), budget_bytes, base, grid,
        cfg.dtype, scan_containers=scan_containers,
        include_skip=include_skip, mesh=mesh, axis=shard_axis,
        progress=progress)


def allocate_recipe(params: dict, cfg: ModelConfig, calib,
                    budget_bytes: int, *, grid=None,
                    qspec: QSpec | None = None,
                    include_skip: bool = False, seed: int = 0,
                    mesh=None, shard_axis: str = "model",
                    progress: Callable[[str], None] | None = None
                    ) -> QuantRecipe:
    """The :class:`QuantRecipe` of :func:`allocate_plan`."""
    return allocate_plan(params, cfg, calib, budget_bytes, grid=grid,
                         qspec=qspec, include_skip=include_skip, seed=seed,
                         mesh=mesh, shard_axis=shard_axis,
                         progress=progress).recipe


# ---------------------------------------------------------------------------
# Abstract quantized parameter shapes and the bucket manifest: planned from
# the config's shapes on the meta device (nothing allocated, no compute).
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_eager_shapes(cfg: ModelConfig) -> dict:
    """The dense eager param tree as meta tensors (shapes and dtypes of
    ``init_params``, nothing allocated)."""
    from repro_torch.models.transformer import init_params
    return init_params(dataclasses.replace(cfg, scan_layers=False),
                       device="meta")


def _abstract_tasks(eshapes: dict,
                    sites: dict[str, SiteSpec]) -> list[LayerTask]:
    """The quantization sites of an abstract tree as meta-tensor
    :class:`LayerTask`s with their resolved specs, discovered and ordered
    as :func:`_gather_tasks` does (skipped sites give no task), so the
    planner gives the real engine's buckets (it reads only ``W.shape``,
    whether there is an ``H``, and the site spec)."""
    tasks: list[LayerTask] = []
    for lin_path in quantizable_linear_paths(eshapes):
        site = sites[lin_path]
        if site.skip:
            continue
        W = get_path(eshapes, lin_path)["w"]
        has_gram = site.method in GRAM_METHODS
        E, (m, n) = (None, W.shape) if W.dim() == 2 else (W.shape[0],
                                                          W.shape[1:])
        H = _meta((m, m), torch.float32) if has_gram else None
        for e in ([None] if E is None else range(E)):
            tasks.append(LayerTask(lin_path, e, _meta((m, n), torch.float32),
                                   H, 0, site=site))
    return tasks


def quantization_manifest(cfg: ModelConfig, method: str | None = None,
                          qspec: QSpec | None = None, *,
                          recipe: QuantRecipe | None = None, mesh=None,
                          shard_axis: str = "model", cost_model=None,
                          _eshapes: dict | None = None) -> dict:
    """Bucket manifest of a ``quantize_model`` run, from abstract shapes
    alone: the batched engine's planner (``batched.plan_buckets``) over
    meta-tensor tasks, serialized (``batched.plan_manifest``: every
    bucket's spec and its tasks), plus

    * ``recipe``: the serialized :class:`QuantRecipe`;
    * ``site_lora``: one entry a weight-shared linear (name, ``n``,
      method), for the per-site adapter stacks;
    * ``stacked``: the containers stacked over layers, when
      ``cfg.scan_layers``.

    The legacy ``(method, qspec)`` pair is taken as a zero-rule recipe.
    JSON-equal to the JAX twin's for the same ``(cfg, recipe)``, with
    ``mesh`` (each bucket's ``n_shards``/``exec_path`` for it) and
    ``cost_model`` (its predicted-time paths) too.  Hand it to
    ``checkpoint.save_tree(..., manifest=)``."""
    from repro_torch.core.costmodel import CostModel
    if recipe is None:
        recipe = QuantRecipe.single(method or "cloq",
                                    qspec or cfg.quant or QSpec())
    elif method is not None or qspec is not None:
        raise ValueError("quantization_manifest: pass either recipe= or "
                         "the legacy (method, qspec) pair, not both")
    eshapes = _abstract_eager_shapes(cfg) if _eshapes is None else _eshapes
    sites = recipe.resolve(quantizable_linear_paths(eshapes))
    _check_scan_uniform(sites, cfg)
    tasks = _abstract_tasks(eshapes, sites)
    buckets = plan_buckets(tasks, mesh=mesh, axis=shard_axis,
                           cost_model=CostModel.coerce(cost_model))
    manifest = plan_manifest(tasks, buckets, axis=shard_axis)
    manifest["recipe"] = recipe.to_dict()
    manifest["site_lora"] = [
        {"name": p[len("shared.block."):].replace(".", "_"),
         "n": int(get_path(eshapes, p)["w"].shape[-1]),
         "method": s.method}
        for p, s in sites.items()
        if p.startswith("shared.block.") and not s.skip]
    if cfg.scan_layers:
        manifest["stacked"] = [k for k in _STACK_KEYS if k in eshapes]
    return manifest


def recipe_plan_bytes(cfg: ModelConfig, recipe: QuantRecipe) -> int:
    """Exact serialized bytes of all quantization sites under ``recipe``,
    from abstract shapes alone (``allocate.site_bytes`` over a whole
    plan; a skipped site counts its dense weight)."""
    from repro_torch.core.allocate import site_bytes
    eshapes = _abstract_eager_shapes(cfg)
    sites = recipe.resolve(quantizable_linear_paths(eshapes))
    site_lora = eshapes.get("shared", {}).get("site_lora", {})
    total = 0
    for lin_path, site in sites.items():
        W = get_path(eshapes, lin_path)["w"]
        experts, (m, n) = (1, W.shape) if W.dim() == 2 else \
            (W.shape[0], W.shape[1:])
        lora_sites = 1
        if lin_path.startswith("shared.block."):
            name = lin_path[len("shared.block."):].replace(".", "_")
            lora_sites = (site_lora[name]["lora_a"].shape[0]
                          if name in site_lora else 0)
        total += site_bytes(m, n, site, cfg.dtype, experts, lora_sites)
    return total


def _quant_leaf_shapes(m: int, n: int, qspec: QSpec, dtype,
                       lead: tuple = (), method: str = "cloq") -> dict:
    """One site's quantized leaves as meta tensors (``lead``: a stacked
    site's leading dims)."""
    g = m if qspec.group_size is None else qspec.group_size
    bits = 4 if method == "qlora" else qspec.bits       # NF4 is always 4-bit
    mp = m * bits // 8 if bits in (2, 4) else m
    out = {"qcodes": _meta(lead + (mp, n), torch.uint8),
           "lora_a": _meta(lead + (m, qspec.rank), dtype),
           "lora_b": _meta(lead + (n, qspec.rank), dtype)}
    if method == "qlora":
        out["absmax"] = _meta(lead + (m // g, n), torch.float32)
    else:
        out["scales"] = _meta(lead + (m // g, n), torch.float32)
        out["zeros"] = _meta(lead + (m // g, n), torch.float32)
    return out


def quantized_param_shapes(cfg: ModelConfig, *, method: str | None = None,
                           recipe: QuantRecipe | None = None,
                           mesh=None, shard_axis: str = "model",
                           with_manifest: bool = False):
    """The post-quantization param tree as meta tensors, in the port's
    layout (what ``quantize_model`` returns for ``cfg``), built without
    calibration or allocation.  Each site's leaves follow its resolved
    ``(bits, group_size, rank)``; a skipped site keeps its dense ``w``; a
    weight-shared block's ``shared.site_lora`` stacks take the resolved
    rank.  Without ``recipe``, ``cfg.quant`` (+ ``method``) is the
    zero-rule recipe.  ``with_manifest=True`` returns ``(shapes,
    manifest)``, the manifest :func:`quantization_manifest`'s on the same
    shapes, planned for ``mesh``."""
    if recipe is None:
        assert cfg.quant is not None, "cfg.quant must be set"
        recipe = QuantRecipe.single(method or "cloq", cfg.quant)
    shapes = _abstract_eager_shapes(cfg)
    sites = recipe.resolve(quantizable_linear_paths(shapes))
    _check_scan_uniform(sites, cfg)
    manifest = (quantization_manifest(cfg, recipe=recipe, mesh=mesh,
                                      shard_axis=shard_axis, _eshapes=shapes)
                if with_manifest else None)
    for lin_path, site in sites.items():
        if site.skip:
            continue                         # dense w stays in place
        qspec = site.qspec
        lin = dict(get_path(shapes, lin_path))
        W = lin.pop("w")
        lead, (m, n) = ((), W.shape) if W.dim() == 2 else \
            ((W.shape[0],), W.shape[1:])
        newlin = _quant_leaf_shapes(m, n, qspec, cfg.dtype, lead,
                                    site.method)
        if lin_path.startswith("shared.block."):
            newlin.pop("lora_a")
            newlin.pop("lora_b")
            # the per-site adapter stacks take the resolved rank
            name = lin_path[len("shared.block."):].replace(".", "_")
            site_lora = get_path(shapes, "shared.site_lora")
            if name in site_lora:
                S = site_lora[name]["lora_a"].shape[0]
                site_lora[name] = {
                    "lora_a": _meta((S, m, qspec.rank), cfg.dtype),
                    "lora_b": _meta((S, n, qspec.rank), cfg.dtype)}
        lin.update(newlin)
        set_path(shapes, lin_path, lin)
    if cfg.scan_layers:
        shapes = to_scan_params(shapes, cfg)    # stacks meta tensors
    if with_manifest:
        return shapes, manifest
    return shapes
