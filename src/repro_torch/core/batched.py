"""Batched layer-wise quantization engine: shape-bucketed stacks of layers.

PyTorch twin of the single-device part of ``repro.core.batched``.  The
per-layer MagR -> OPTQ -> CLoQ stack (and the LoftQ/QLoRA/RTN/GPTQ-LoRA
baselines) is closed-form, so nothing in it is sequential across layers.
Run layer by layer, a model's quantization pays one sweep of small
launches, one ``eigh`` and one ``svd`` per linear; this module runs them a
bucket at a time:

1.  **Planner** (:func:`plan_buckets`): every quantization site is a
    :class:`LayerTask`.  Tasks are grouped into buckets keyed by
    :class:`BucketSpec`: ``(m, n, method, bits, group_size, rank, split,
    block_size, ...)``, from each task's resolved per-site spec
    (``LayerTask.site``) or the global pair.  Everything shape- or
    branch-like (OPTQ's sweep block via :func:`repro_torch.core.optq.
    pick_block`, the MagR gate ``bits <= 4``) is resolved here.  On
    Qwen3-1.7B's 28 layers that gives four buckets: q and o (2048 x 2048,
    56 sites), k and v (2048 x 1024, 56), gate and up (2048 x 6144, 56),
    down (6144 x 2048, 28).  Each expert of a stacked MoE site is a task
    of its own (``LayerTask.expert``), so an expert stack is a natural
    bucket: OLMoE-1B-7B's 16 layers give 2048 gate and up slices of 2048
    x 1024 in one bucket.

2.  **Executor** (:func:`run_bucket` / :func:`quantize_layer_batch`): each
    bucket stacks its ``(W, H)`` pairs to ``(L, m, n)`` / ``(L, m, m)`` and
    runs the method's stack once over the whole stack: every op of the
    OPTQ row sweep covers the row of all ``L`` matrices, MagR and the tail
    updates are batched products, and ``eigh``/``svd`` factor the stack in
    one call each.  A bucket whose working set would not fit the card is
    staged and run in consecutive chunks (:func:`chunk_size`, from the
    memory free before each chunk), each one such call, the results joined
    in task order; the bucket stays the unit of the plan, the journal and
    the health report.  Random LoRA
    inits come from one ``torch.Generator`` a task, seeded from ``(seed,
    site index)`` (an expert's from ``(seed, site index, expert)``,
    :func:`task_key`), so the batched and sequential engines draw the same
    bits.

3.  **Sharding** (:func:`run_bucket_sharded`): on a mesh
    (:mod:`repro_torch.launch.mesh`, one rank a mesh position, every rank
    running the same plan) the planner gives each bucket ``n_shards``
    column shards over the ``model`` axis (``1``, replicated, only when
    ``n`` does not divide the axis; or where the cost model,
    :mod:`repro_torch.core.costmodel`, predicts another path faster).
    Each rank stages only its own columns ``W[..., cols]`` (the Grams whole)
    and runs the same stacked method stack on them; the only communication
    is the Gram trick's all-reduce: one ``(L, m, m)`` a bucket for CLoQ
    (:func:`repro_torch.core.cloq.cloq_lowrank_local`), one an AltMin round
    for LoftQ (:func:`repro_torch.core.loftq.svd_lowrank_topr`).  Random
    ``lora_a`` is drawn from the task's generator on every rank, the bits
    of the unsharded engine's.  A sharded task's leaves are DTensors of its
    rank's block (:func:`task_leaf_specs`: column leaves ``Shard`` over the
    axis, ``lora_a`` ``Replicate``); ``models.parallel.gather_tree`` makes
    them whole.

4.  **Runtime**: the health check of every finished bucket and the
    degradation ladder for failing slices (:mod:`repro_torch.core.health`),
    the quantization journal (:class:`repro_torch.checkpoint.manager.
    QuantJournal`) that makes a run resumable at bucket boundaries, and the
    fault-injection points they are tested with
    (:mod:`repro_torch.core.faults`).

Bits: the stacked products, reductions and factorizations may sum in
another order than the 2-D calls (on the CPU they happen not to; on the
H100 they do), and OPTQ's error feedback carries a near-tie flip down
its column, so the engines agree as closely as a one-ulp change of the
Gram lets one engine agree with itself: on Qwen3-1.7B at full width on
the H100 that is up to 5% of a site's codes, with the calibrated
objective within 1e-3 (``PERF.md``).  Within one engine a slice's
result depends on the other slices of its bucket only through summation
order: a bucket run in chunks (stacked calls of other lengths) gives the
bits of one call at the CPU tests' shapes, and is held to the engines'
oracle on the card (``chip_smoke.py``, ``engines``).

5.  **Sensitivity sweep** (:func:`evaluate_layer_batch`): the bit
    allocator's (:mod:`repro_torch.core.allocate`) proxy error
    ``tr(E^T H E)``, ``E = W - Q - A B^T``, of every ``(site,
    candidate)`` task, planned with ``for_eval=True`` (every task's Gram
    weights its error, data-free methods included) and run a bucket chunk
    at a time, one stacked call each (:func:`run_bucket_eval`); sharded
    buckets all-reduce each slice's error (:func:`run_bucket_eval_sharded`).

``compile_cache=`` names the directory this process's kernel libraries
are built into and loaded from (``kernels.build.use_cache``); the buckets
run eagerly, so nothing else is compiled.  The reference has no chunks: it
sends a bucket that would not fit to its sequential path through the cost
model (which the port also has); here a chunk is sized from the free
memory of the rank's device, so ranks sharing one card each see the other's
allocations only as they happen.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.core.cloq import (cloq_init, cloq_lowrank_local, gram_root,
                                   regularize_gram)
from repro_torch.core.loftq import (gptq_lora_init, lora_normal, loftq_init,
                                    qlora_init)
from repro_torch.core.magr import magr_alpha, magr_preprocess
from repro_torch.core.optq import optq_quantize_core, pick_block
from repro_torch.core.quantizer import (QuantConfig, dequantize_int,
                                        pack_codes, quantize_int)
from repro_torch.kernels import build
from repro_torch.models import parallel
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace

if TYPE_CHECKING:
    from repro_torch.core.recipe import SiteSpec

Tensor = torch.Tensor

# methods whose base quantization consumes a calibration Gram
GRAM_METHODS = ("cloq", "gptq")

# methods whose LoRA init draws a random A (B = 0)
_RANDOM_A_METHODS = ("gptq", "qlora", "rtn")

# methods the planner must keep replicated on a mesh.  Empty: every method's
# stack is column-local given the Gram, the two full-width SVDs (CLoQ's
# R dW, LoftQ's per-round W - Q) recovered exactly by the Gram trick
_REPLICATED_METHODS: tuple[str, ...] = ()


def bucket_axis_size(mesh, axis: str = "model") -> int:
    """Size of the mesh's ``axis`` (``1`` without a mesh or that axis):
    the candidate shard count of the planner and the cost model.

    >>> bucket_axis_size(None)
    1
    """
    return parallel.axis_size(mesh, axis)


def bucket_shards(n: int, method: str, mesh=None,
                  axis: str = "model") -> int:
    """Column shards the planner gives a bucket: the ``axis`` size of
    ``mesh`` when ``n`` divides it (and the method is not kept replicated:
    none is), else ``1``.  The divisibility gate only; with a cost model
    the planner re-decides each bucket's path (:func:`apply_cost_model`).

    >>> bucket_shards(48, "cloq", mesh=None)
    1
    """
    k = bucket_axis_size(mesh, axis)
    if k <= 1 or method in _REPLICATED_METHODS or n % k != 0:
        return 1
    return k


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static signature of one bucket.  Hashable: the bucket key."""
    m: int
    n: int
    method: str
    bits: int
    group_size: int | None
    rank: int
    split: str
    block_size: int          # OPTQ sweep block, already a divisor of m
    act_order: bool
    lambda_frac: float
    magr: bool               # MagR gate (bits <= 4), resolved at plan time
    magr_iters: int
    has_gram: bool
    n_shards: int = 1        # column shards over the model axis (1 = local)
    # "replicated" (one stacked call), "sharded" (one stacked call a rank on
    # its columns, n_shards > 1) or "sequential" (one call a slice, chosen
    # only by the cost model's memory gate); kept in the bucket manifest
    exec_path: str = "replicated"


@dataclasses.dataclass
class LayerTask:
    """One quantization site (or one expert of a stacked site): a 2-D
    weight, its Gram and the seed of its random LoRA init
    (:func:`task_key`)."""
    path: str                # lin path in the param tree
    expert: int | None       # index into a stacked (E, m, n) weight
    W: Tensor                # (m, n)
    H: Tensor | None         # (m, m) calibration Gram
    key: int                 # seed of the task's torch.Generator
    site: "SiteSpec | None" = None   # resolved per-site spec (optional)


def task_key(seed: int, index: int, expert: int | None = None) -> int:
    """The seed of site ``index``'s generator (its position among the
    model's quantizable paths, skipped sites included), from the run's
    ``seed``, and of its expert ``expert`` for a stacked site: one stream a
    site or expert, the same in every engine."""
    entropy = [seed, index] + ([] if expert is None else [expert])
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] & np.uint64(2 ** 63 - 1))


def _draw_a(keys: list[int], m: int, rank: int,
            device: torch.device) -> Tensor:
    """The stacked random LoRA ``A`` of a bucket: one ``(m, rank)`` draw
    from each task's own generator."""
    out = []
    for k in keys:
        gen = torch.Generator(device=device)
        gen.manual_seed(k)
        out.append(lora_normal(gen, m, rank, device))
    return torch.stack(out)


def task_site(t: LayerTask, qspec=None, method: str | None = None):
    """A task's effective ``(qspec, method)``: its resolved site spec when
    present, else the global fallback pair."""
    if t.site is not None:
        return t.site.qspec, t.site.method
    if qspec is None or method is None:
        raise ValueError(
            f"task {t.path!r} carries no resolved SiteSpec and no global "
            "(qspec, method) fallback was given")
    return qspec, method


def make_spec(m: int, n: int, qspec, method: str, has_gram: bool,
              base: QuantConfig | None = None, *, mesh=None,
              axis: str = "model", for_eval: bool = False) -> BucketSpec:
    """Resolve all static/branching decisions for one (shape, method),
    with ``mesh`` the bucket's column shards over ``axis`` too
    (:func:`bucket_shards`).  ``for_eval`` marks a sensitivity-sweep
    bucket (:func:`evaluate_layer_batch`): the Gram is then routed into the
    bucket whenever one exists, so every candidate's proxy error is
    weighted by the same calibration data, data-free methods' too."""
    base = base or QuantConfig(bits=qspec.bits, group_size=qspec.group_size)
    k = bucket_shards(n, method, mesh, axis)
    return BucketSpec(
        m=m, n=n, method=method, bits=qspec.bits,
        group_size=qspec.group_size, rank=qspec.rank, split=qspec.split,
        block_size=pick_block(m, base.block_size),
        act_order=base.act_order, lambda_frac=base.lambda_frac,
        magr=(method == "cloq" and qspec.bits <= 4),
        magr_iters=base.magr_iters,
        has_gram=has_gram and (for_eval or method in GRAM_METHODS),
        n_shards=k, exec_path="sharded" if k > 1 else "replicated")


def spec_qcfg(spec: BucketSpec) -> QuantConfig:
    """The :class:`QuantConfig` a plan-time :class:`BucketSpec` stands for
    (single source of truth for the mapping)."""
    return QuantConfig(bits=spec.bits, group_size=spec.group_size,
                       block_size=spec.block_size, act_order=spec.act_order,
                       lambda_frac=spec.lambda_frac)


def _quantize_core(W: Tensor, H: Tensor | None, A0: Tensor | None,
                   spec: BucketSpec, group=None) -> tuple[dict, Tensor]:
    """The method stack on one weight ``(m, n)`` or a bucket's stack ``(L,
    m, n)`` (Grams ``(L, m, m)``, random ``A0 (L, m, r)``).  Returns
    ``(leaves, Qd)``: f32 factors, packed codes, and the dequantized
    base.  Every leaf is a tensor of its own: a factor left as a view of
    an SVD's output (CLoQ's ``B``) would keep the whole output alive for as
    long as the engine holds the slice's leaves (4-8 MB a slice for an
    OLMoE-1B-7B expert, against 2 MB of leaves).  With ``group`` (the
    mesh axis's process group) ``W`` is the rank's column shard: CLoQ and
    LoftQ take the Gram-trick solves, every other op is per column."""
    leaves, Qd = _method_stack(W, H, A0, spec, group)
    return {k: v.contiguous() for k, v in leaves.items()}, Qd


def _method_stack(W: Tensor, H: Tensor | None, A0: Tensor | None,
                  spec: BucketSpec, group=None) -> tuple[dict, Tensor]:
    qcfg = spec_qcfg(spec)
    W = W.float()
    m, n = spec.m, W.shape[-1]          # n is the rank's under a mesh
    if spec.method == "cloq":
        H = H.float()
        Wp = (magr_preprocess(W, H, alpha=magr_alpha(H, m),
                              iters=spec.magr_iters) if spec.magr else W)
        Qd, Qc, s, z = optq_quantize_core(Wp, H, qcfg)
        del Wp
        # spec.lambda_frac regularizes both the OPTQ damping (via qcfg) and
        # the CLoQ Gram root, so the ladder's re-damp rung reaches both
        Hreg = regularize_gram(H, spec.lambda_frac)
        if group is None:
            A, B = cloq_init(Hreg, W - Qd, spec.rank, spec.split)
        else:
            R, Rinv = gram_root(Hreg)
            A, B = cloq_lowrank_local(R, Rinv, W - Qd, spec.rank, spec.split,
                                      group)
            del R, Rinv
        del Hreg
        return {"qcodes": pack_codes(Qc, spec.bits), "scales": s, "zeros": z,
                "lora_a": A, "lora_b": B}, Qd
    if spec.method == "gptq":
        Qd, Qc, s, z = optq_quantize_core(W, H.float(), qcfg)
        A, B = gptq_lora_init(A0, n)
        return {"qcodes": pack_codes(Qc, spec.bits), "scales": s, "zeros": z,
                "lora_a": A, "lora_b": B}, Qd
    if spec.method == "loftq":
        Qd, A, B, (codes, s, z) = loftq_init(W, qcfg, spec.rank, iters=5,
                                             group=group)
        return {"qcodes": pack_codes(codes, spec.bits), "scales": s,
                "zeros": z, "lora_a": A, "lora_b": B}, Qd
    if spec.method == "qlora":
        Qd, A, B, (codes, absmax) = qlora_init(W, qcfg, A0)
        return {"qcodes": pack_codes(codes, 4), "absmax": absmax,
                "lora_a": A, "lora_b": B}, Qd
    if spec.method == "rtn":
        codes, s, z = quantize_int(W, spec.bits, spec.group_size)
        Qd = dequantize_int(codes, s, z, spec.group_size)
        A, B = gptq_lora_init(A0, n)
        return {"qcodes": pack_codes(codes, spec.bits), "scales": s,
                "zeros": z, "lora_a": A, "lora_b": B}, Qd
    raise ValueError(f"unknown method {spec.method}")


def _random_a(keys: list[int], spec: BucketSpec,
              device: torch.device) -> Tensor | None:
    if spec.method not in _RANDOM_A_METHODS:
        return None
    return _draw_a(keys, spec.m, spec.rank, device)


def quantize_single_deq(W: Tensor, H: Tensor | None, key: int,
                        spec: BucketSpec,
                        group=None) -> tuple[dict, Tensor]:
    """One site ``W (m, n)`` with its Gram (``None`` for data-free
    methods) and generator seed: ``(leaves, Qd)``, ``Qd`` the dequantized
    base.  The sequential engine's and the health ladder's core.  With
    ``group`` ``W`` is the rank's column shard ``(m, n_local)`` and the
    column leaves cover those columns; ``lora_a`` is the same on every
    rank (the all-reduced Gram, or the task's generator)."""
    A0 = _random_a([key], spec, W.device)
    return _quantize_core(W, H, None if A0 is None else A0[0], spec, group)


def quantize_single(W: Tensor, H: Tensor | None, key: int,
                    spec: BucketSpec, group=None) -> dict:
    """The leaf dict of :func:`quantize_single_deq`."""
    return quantize_single_deq(W, H, key, spec, group)[0]


def _proxy_error(W: Tensor, H: Tensor | None, leaves: dict, Qd: Tensor,
                 has_gram: bool) -> Tensor:
    """``tr(E^T H E)`` (``||E||_F^2`` without a Gram), ``E = W - Q - A
    B^T``, in f32, of one site or of each slice of a stack (``(L,)``)."""
    E = W.float() - Qd - leaves["lora_a"] @ leaves["lora_b"].mT
    if has_gram:
        return (E * (H.float() @ E)).sum((-2, -1))
    return (E * E).sum((-2, -1))


def eval_single(W: Tensor, H: Tensor | None, key: int,
                spec: BucketSpec, group=None) -> Tensor:
    """Calibration-weighted proxy error of quantizing this site with
    ``spec``: ``tr(E^T H E)``, ``E = W - Q - A B^T`` (the unweighted
    ``||E||_F^2`` when the spec carries no Gram), from the same stack as
    :func:`quantize_single_deq`, so it ranks what the engine would
    produce.  With ``group`` each column's ``e_j^T H e_j`` is the rank's
    given the whole Gram, and one all-reduce sums them."""
    leaves, Qd = quantize_single_deq(W, H, key, spec, group)
    return parallel.all_reduce_sum(
        _proxy_error(W, H, leaves, Qd, spec.has_gram), group)


def run_bucket(Ws: Tensor, Hs: Tensor | None, keys: list[int],
               spec: BucketSpec) -> dict:
    """One bucket in one stacked call: ``Ws (L, m, n)``, ``Hs (L, m, m)``
    (``None`` for data-free methods), one generator seed a task.  Returns
    the stacked leaves (leading dim ``L``)."""
    A0 = _random_a(keys, spec, Ws.device)
    return _quantize_core(Ws, Hs, A0, spec)[0]


def run_bucket_eval(Ws: Tensor, Hs: Tensor | None, keys: list[int],
                    spec: BucketSpec) -> Tensor:
    """Sensitivity-sweep analog of :func:`run_bucket`: the ``(L,)`` proxy
    errors of one bucket's stack in one stacked call, left on the
    device."""
    A0 = _random_a(keys, spec, Ws.device)
    leaves, Qd = _quantize_core(Ws, Hs, A0, spec)
    return _proxy_error(Ws, Hs, leaves, Qd, spec.has_gram)


def run_bucket_sharded(Ws: Tensor, Hs: Tensor | None, keys: list[int],
                       spec: BucketSpec, mesh, axis: str = "model") -> dict:
    """One bucket on this rank's columns: ``Ws (L, m, n / k)`` the rank's
    column shard of the stack (:func:`_stage_bucket` with its columns),
    ``Hs (L, m, m)`` whole, one generator seed a task.  Every rank runs
    the same stacked method stack on its own columns; the only
    communication is CLoQ's ``(L, m, m)`` all-reduce (LoftQ's, one an
    AltMin round).  Returns the rank's stacked leaves (column leaves cover
    its columns, ``lora_a`` whole); :func:`shard_leaves` makes a task's
    DTensors."""
    A0 = _random_a(keys, spec, Ws.device)
    return _quantize_core(Ws, Hs, A0, spec,
                          parallel.axis_group(mesh, axis))[0]


def run_bucket_eval_sharded(Ws: Tensor, Hs: Tensor | None, keys: list[int],
                            spec: BucketSpec, mesh,
                            axis: str = "model") -> Tensor:
    """Distributed :func:`run_bucket_eval` on the rank's column shard: each
    slice's error summed over the ranks by one ``(L,)`` all-reduce, the
    same on every rank."""
    group = parallel.axis_group(mesh, axis)
    A0 = _random_a(keys, spec, Ws.device)
    leaves, Qd = _quantize_core(Ws, Hs, A0, spec, group)
    return parallel.all_reduce_sum(
        _proxy_error(Ws, Hs, leaves, Qd, spec.has_gram), group)


def task_leaf_specs(method: str, axis: str | None = "model",
                    lead: int = 0) -> dict:
    """Layouts of ONE task's (unstacked) leaves, the JAX twin's
    PartitionSpecs as tuples: column leaves (``qcodes``, ``scales``,
    ``zeros``, ``absmax``) shard their last dim over ``axis``, ``lora_b``
    ``(n, r)`` its first, ``lora_a`` is replicated.  ``axis=None`` is the
    replicated layout; ``lead`` prepends that many unsharded dims (a
    stacked expert site's ``E``).  The source of truth for sharded leaves,
    :func:`bucket_out_specs` and ``checkpoint.manager.manifest_shardings``."""
    pre = (None,) * lead
    col = (*pre, None, axis)
    out = {"qcodes": col, "lora_a": (*pre, None, None),
           "lora_b": (*pre, axis, None)}
    if method == "qlora":
        out["absmax"] = col
    else:
        out["scales"] = col
        out["zeros"] = col
    return out


def bucket_out_specs(method: str, axis: str = "model") -> dict:
    """Layouts of one sharded bucket's stacked leaves: :func:`task_leaf_specs`
    under an unsharded leading bucket dim ``L``."""
    return {k: (None, *sp) for k, sp in task_leaf_specs(method, axis).items()}


def shard_leaves(leaves: dict, method: str, mesh, axis: str = "model", *,
                 local: bool = True) -> dict:
    """One task's leaves as DTensors of the layout :func:`task_leaf_specs`
    gives: ``local=True`` when they already are the rank's blocks (the
    sharded bucket's output), ``False`` for whole leaves (a healed slice,
    a journal entry) whose blocks are cut here."""
    specs = task_leaf_specs(method, axis)
    out = {}
    for k, v in leaves.items():
        blk = v if local else parallel.local_slice(v, specs[k], mesh)
        out[k] = parallel.distribute_local(blk.contiguous(), specs[k], mesh)
    return out


def per_layer_sharded_dispatch(tasks: list[LayerTask], qspec, mesh,
                               axis: str = "model",
                               base: QuantConfig | None = None) -> list:
    """The per-layer baseline of :func:`run_bucket_sharded`: one sharded
    OPTQ call and one sharded CLoQ solve a layer (MagR on the whole
    weight on every rank), with the MagR gate and alpha of
    :func:`quantize_single`.  Returns each task's ``(A, B)`` as DTensors
    (``A`` replicated, ``B`` row-sharded)."""
    from repro_torch.core.optq import optq_quantize_sharded
    group = parallel.axis_group(mesh, axis)
    outs = []
    for t in tasks:
        m, n = t.W.shape
        spec = make_spec(m, n, qspec, "cloq", t.H is not None, base,
                         mesh=mesh, axis=axis)
        W, H = t.W.float(), t.H.float()
        W_q = (magr_preprocess(W, H, alpha=magr_alpha(H, m),
                               iters=spec.magr_iters) if spec.magr else W)
        Qd = optq_quantize_sharded(W_q, H, spec_qcfg(spec), mesh, axis)[0]
        dW_l = parallel.local_slice(W, (None, axis), mesh) - Qd.to_local()
        R, Rinv = gram_root(regularize_gram(H))
        A, B_l = cloq_lowrank_local(R, Rinv, dW_l, spec.rank, spec.split,
                                    group)
        outs.append((parallel.distribute_local(A, (None, None), mesh),
                     parallel.distribute_local(B_l, (axis, None), mesh)))
    return outs


def apply_cost_model(buckets: dict[BucketSpec, list[int]], cost_model, *,
                     mesh=None,
                     axis: str = "model") -> dict[BucketSpec, list[int]]:
    """Re-decide each planned bucket's execution path from predicted time:
    ``cost_model.decide(spec, L, k)`` (:class:`repro_torch.core.costmodel.
    CostModel`) picks replicated / sharded / sequential now that the
    bucket's size ``L`` is known.  Bucket membership does not change;
    insertion order is kept.  ``cost_model=None`` is the identity."""
    if cost_model is None:
        return buckets
    k = bucket_axis_size(mesh, axis)
    out: dict[BucketSpec, list[int]] = {}
    for spec, idxs in buckets.items():
        k_eff = 1 if spec.method in _REPLICATED_METHODS else k
        path, shards = cost_model.decide(spec, len(idxs), k_eff)
        spec = dataclasses.replace(spec, exec_path=path, n_shards=shards)
        out.setdefault(spec, []).extend(idxs)
    return out


def run_bucket_sequential(Ws: Tensor, Hs: Tensor | None, keys: list[int],
                          spec: BucketSpec) -> dict:
    """One bucket a slice at a time, outputs stacked to
    :func:`run_bucket`'s layout: ``L`` calls of the single-site core, peak
    memory ``1/L`` of the stacked call."""
    outs = [quantize_single(Ws[j], None if Hs is None else Hs[j], keys[j],
                            requeue_spec(spec))
            for j in range(Ws.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def requeue_spec(spec: BucketSpec) -> BucketSpec:
    """The spec a fresh single-slice plan would give this bucket: what the
    health ladder requeues a failing slice under."""
    return dataclasses.replace(spec, n_shards=1, exec_path="replicated")


def plan_buckets(tasks: list[LayerTask], qspec=None,
                 method: str | None = None, base: QuantConfig | None = None,
                 *, mesh=None, axis: str = "model", for_eval: bool = False,
                 cost_model=None) -> dict[BucketSpec, list[int]]:
    """Group task indices by bucket signature (insertion-ordered).  Tasks
    carrying a resolved ``site`` bucket by their own spec; the rest by the
    global ``(qspec, method)``.  ``mesh``: buckets whose column count
    divides ``axis`` get ``n_shards > 1`` (:func:`run_bucket_sharded`).
    ``for_eval`` plans sensitivity-sweep buckets (:func:`make_spec`).
    ``cost_model`` (a :class:`repro_torch.core.costmodel.CostModel`)
    re-decides each bucket's path from predicted time
    (:func:`apply_cost_model`).  Raises ``ValueError`` when a
    Gram-consuming method has no Gram."""
    buckets: dict[BucketSpec, list[int]] = {}
    for i, t in enumerate(tasks):
        t_qspec, t_method = task_site(t, qspec, method)
        m, n = t.W.shape
        has_gram = t.H is not None
        if t_method in GRAM_METHODS and not has_gram:
            raise ValueError(
                f"method {t_method!r} needs a calibration Gram for {t.path}"
                f"{'' if t.expert is None else f'[expert {t.expert}]'}")
        spec = make_spec(m, n, t_qspec, t_method, has_gram, base, mesh=mesh,
                         axis=axis, for_eval=for_eval)
        buckets.setdefault(spec, []).append(i)
    return apply_cost_model(buckets, cost_model, mesh=mesh, axis=axis)


def plan_manifest(tasks: list[LayerTask],
                  buckets: dict[BucketSpec, list[int]],
                  axis: str = "model") -> dict:
    """One planner run as JSON-able data: every bucket's spec and the task
    -> bucket assignment (the reference's bucket manifest format)."""
    return {
        "version": 1,
        "axis": axis,
        "buckets": [
            {"spec": dataclasses.asdict(spec),
             "tasks": [{"path": tasks[i].path, "expert": tasks[i].expert}
                       for i in idxs]}
            for spec, idxs in buckets.items()],
    }


def rank_columns(spec: BucketSpec, mesh,
                 axis: str = "model") -> slice | None:
    """This rank's columns of a sharded bucket (``None``: all of them)."""
    if spec.n_shards <= 1:
        return None
    step = spec.n // spec.n_shards
    r = parallel.axis_rank(mesh, axis)
    return slice(r * step, (r + 1) * step)


def _stage_bucket(tasks: list[LayerTask], idxs: list[int],
                  spec: BucketSpec, cols: slice | None = None):
    """Stack one bucket's ``(W, H)`` pairs as f32 on their device (``W``'s
    columns ``cols`` only: a rank's shard); the generator seeds stay a
    list."""
    cols = slice(None) if cols is None else cols
    Ws = torch.stack([tasks[i].W[:, cols].float() for i in idxs])
    Hs = None
    if spec.has_gram:
        Hs = torch.stack([tasks[i].H.float() for i in idxs])
    return Ws, Hs, [tasks[i].key for i in idxs]


# a slice's peak working set in a stacked call, as a multiple of its f32
# W and H bytes (the staged stack, MagR's and OPTQ's copies, the Gram root
# and the SVD's factors): 5.5-6.4 on an H100 at 4 slices a call
# (chip_smoke.py, the quantize_split line's slice_factor; PERF.md), with
# room for the staging's transient copies
SLICE_WORK_FACTOR = 8.0
# device memory left free when a bucket is cut into chunks
CHUNK_MARGIN_BYTES = 2 << 30


def slice_bytes(spec: BucketSpec) -> int:
    """f32 bytes of one slice's staged ``W`` (a rank's columns when
    sharded) and ``H``."""
    n = spec.n // spec.n_shards
    return 4 * (spec.m * n + (spec.m * spec.m if spec.has_gram else 0))


def free_bytes(device: torch.device) -> int:
    """Device memory a new allocation can take: the free memory
    ``mem_get_info`` reports and what PyTorch's caching allocator holds
    unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def chunk_size(spec: BucketSpec, n_slices: int, device: torch.device,
               chunk: int | None = None) -> int:
    """Slices a stacked call of this bucket takes: ``chunk`` when given,
    all of them on a device other than CUDA, else as many as
    ``SLICE_WORK_FACTOR`` x :func:`slice_bytes` fit in
    :func:`free_bytes` less ``CHUNK_MARGIN_BYTES`` (at least one).  The
    caching allocator's unused blocks are released first: counted as
    free while cached, fragmented blocks let a chunk be sized from room
    that no allocation of its size could take (Zamba2-7B at 81 layers
    ran out of memory with 6.4 GB cached and unused)."""
    if chunk is not None:
        return max(1, min(int(chunk), n_slices))
    if device.type != "cuda":
        return n_slices
    torch.cuda.empty_cache()
    room = free_bytes(device) - CHUNK_MARGIN_BYTES
    fit = int(room // (SLICE_WORK_FACTOR * slice_bytes(spec)))
    return max(1, min(n_slices, fit))


def quantize_layer_batch(tasks: list[LayerTask], qspec=None,
                         method: str | None = None,
                         base: QuantConfig | None = None,
                         progress: Callable[[str], None] | None = None,
                         *, mesh=None, axis: str = "model",
                         stream: bool = True, policy=None, report=None,
                         journal=None,
                         should_stop: Callable[[], bool] | None = None,
                         cost_model=None, compile_cache=None,
                         chunk: int | None = None) -> list[dict | None]:
    """Quantize all ``tasks`` bucket by bucket.

    Each bucket runs in consecutive chunks of :func:`chunk_size` slices,
    sized before each chunk from the memory then free (one chunk when the
    bucket fits the card, always on the CPU; ``chunk`` forces that many
    slices a chunk), each chunk staged and run as one stacked call.
    ``stream`` (default on): the next bucket's first chunk is staged
    before the host waits on anything of this bucket's last;
    ``stream=False`` synchronizes the device after each chunk.  Streaming
    runs the same operations on the same inputs, so it gives the same
    bits; chunks may sum in another order (module doc).  ``policy`` (a
    :class:`repro_torch.core.health.HealthPolicy`): when enabled, every
    finished chunk is checked and failing slices walk the degradation
    ladder (``None`` results are sites left dense); ``report`` collects the ladder records (made here when
    ``policy`` is on without one).  ``journal`` (a ``QuantJournal``): every
    finished bucket is committed before the next one's results land, and
    buckets whose committed entry matches this plan are restored instead
    of computed (the entry does not depend on the chunks).
    ``should_stop`` is polled at every bucket boundary after the commit;
    True raises :class:`repro_torch.core.health.QuantPreempted`.
    ``progress`` gets one ``[bucket]`` line a bucket
    (``obs.log.format_event``; ``path``, ``shards`` as in the JAX twin).

    ``mesh`` (every rank of it calls this with the same tasks): a bucket
    with ``n_shards > 1`` runs on each rank's columns
    (:func:`run_bucket_sharded`), its leaves DTensors (:func:`shard_leaves`);
    the health check sums each slice's errors over the ranks; a healed
    slice is recomputed whole on every rank and cut to its blocks; the
    journal gathers each bucket and rank 0 writes it, and a restored entry
    is cut to the rank's blocks.  ``cost_model`` (a
    :class:`repro_torch.core.costmodel.CostModel`, or what its ``coerce``
    takes): each bucket's path from predicted time (:func:`plan_buckets`).
    Spans (``repro_torch.obs.trace``, the JAX
    twin's names and arguments): ``quant.plan``; a ``bucket.stage``, a
    ``bucket.execute`` and, when guarded, a ``bucket.health_check`` a
    chunk (``layers`` its slices), the last two fenced under
    ``REPRO_TRACE_SYNC=1``.

    Returns one leaf dict per task, in task order."""
    from repro_torch.core import faults, health

    from repro_torch.core.costmodel import CostModel

    if compile_cache is not None:
        build.use_cache(compile_cache)
    cost_model = CostModel.coerce(cost_model)
    with obs_trace.span("quant.plan", tasks=len(tasks)) as sp:
        buckets = plan_buckets(tasks, qspec, method, base, mesh=mesh,
                               axis=axis, cost_model=cost_model)
        sp.set(buckets=len(buckets))
    results: list[dict | None] = [None] * len(tasks)
    items = list(buckets.items())
    guarded = policy is not None and policy.enabled
    if guarded and report is None:
        report = health.HealthReport()

    # journal resume: buckets whose committed entry matches this plan
    # (spec + ordered task ids); stale entries are recomputed
    loaded: dict[int, list] = {}
    if journal is not None:
        for b, (spec, idxs) in enumerate(items):
            task_ids = [[tasks[i].path, tasks[i].expert] for i in idxs]
            entry = journal.load_bucket(b, dataclasses.asdict(spec),
                                        task_ids,
                                        device=tasks[idxs[0]].W.device)
            if entry is None:
                continue
            loaded[b] = entry[0]
            if spec.n_shards > 1:
                loaded[b] = [None if r is None else
                             shard_leaves(r, spec.method, mesh, axis,
                                          local=False)
                             for r in loaded[b]]
            obs_metrics.counter(obs_names.JOURNAL_RESTORED).inc()
            obs_metrics.counter(obs_names.JOURNAL_SKIPPED_TASKS).inc(
                len(idxs))
            if report is not None:
                report.records.update(entry[1])
                report.event(f"bucket {b} restored from journal "
                             f"({len(idxs)} slices skipped)")

    group = (parallel.axis_group(mesh, axis)
             if bucket_axis_size(mesh, axis) > 1 else None)

    def run(spec: BucketSpec, staged) -> dict:
        Ws, Hs, keys = staged
        if spec.n_shards > 1:
            return run_bucket_sharded(Ws, Hs, keys, spec, mesh, axis)
        if spec.exec_path == "sequential":
            return run_bucket_sequential(Ws, Hs, keys, spec)
        return run_bucket(Ws, Hs, keys, spec)

    def stage(b: int, cidxs: list[int]):
        with obs_trace.span("bucket.stage", bucket=b, layers=len(cidxs)):
            return _stage_bucket(tasks, cidxs, items[b][0],
                                 rank_columns(items[b][0], mesh, axis))

    def size_of(b: int, left: int) -> int:
        """Slices of bucket ``b``'s next chunk, ``left`` still to run: the
        memory is read afresh, as the finished chunks' leaves stay."""
        spec, idxs = items[b]
        return chunk_size(spec, left, tasks[idxs[0]].W.device, chunk)

    # (bucket, chunk size, its first chunk staged ahead)
    ahead: tuple[int, int, tuple] | None = None
    for b in range(len(items)):
        spec, idxs = items[b]
        if b in loaded:
            ahead = None
            if progress:
                progress(obs_log.format_event(
                    "bucket", i=b, restored="journal", layers=len(idxs)))
            for j, i in enumerate(idxs):
                results[i] = loaded[b][j]
            continue
        sizes: list[int] = []
        path = "sharded" if spec.n_shards > 1 else spec.exec_path
        sharded = spec.n_shards > 1
        while sum(sizes) < len(idxs):
            pos = sum(sizes)
            if pos == 0 and ahead is not None and ahead[0] == b:
                size, cur = ahead[1], ahead[2]
            else:
                size = size_of(b, len(idxs) - pos)
                cur = stage(b, idxs[pos:pos + size])
            cidxs = idxs[pos:pos + size]
            sizes.append(size)
            ahead = None
            with obs_trace.span("bucket.execute", bucket=b, path=path,
                                shards=spec.n_shards,
                                layers=len(cidxs)) as sp:
                out = run(spec, cur)
                sp.sync(out)    # REPRO_TRACE_SYNC=1: fence before close
            last = sum(sizes) == len(idxs)
            if stream and last and b + 1 < len(items) and \
                    (b + 1) not in loaded:
                # stage bucket b+1's first chunk before anything waits on
                # this one
                nidxs = items[b + 1][1]
                nsize = size_of(b + 1, len(nidxs))
                ahead = (b + 1, nsize, stage(b + 1, nidxs[:nsize]))
            elif not stream and cur[0].is_cuda:
                torch.cuda.synchronize(cur[0].device)
            for j, i in enumerate(cidxs):
                res = {k: v[j] for k, v in out.items()}
                results[i] = (shard_leaves(res, spec.method, mesh, axis)
                              if sharded else res)
            if guarded:
                with obs_trace.span("bucket.health_check", bucket=b,
                                    layers=len(cidxs)) as hsp:
                    ok = health.check_bucket(cur[0], out, spec, policy,
                                             group=group if sharded
                                             else None)
                    hsp.sync(ok)
                report.checked += len(cidxs)
                obs_metrics.counter(obs_names.HEALTH_CHECKED).inc(
                    len(cidxs))
                for j, i in enumerate(cidxs):
                    if not ok[j]:
                        t = tasks[i]
                        results[i] = health.heal_task(
                            t.W, t.H, t.key, spec, policy, report, t.path,
                            t.expert)
                        if sharded and results[i] is not None:
                            results[i] = shard_leaves(
                                results[i], spec.method, mesh, axis,
                                local=False)
            del cur, out
        obs_metrics.counter(obs_names.QUANT_BUCKETS).inc()
        obs_metrics.counter(obs_names.QUANT_TASKS).inc(len(idxs))
        obs_metrics.counter(obs_names.QUANT_PATH + path).inc()
        if progress:
            g = "col" if spec.group_size is None else spec.group_size
            progress(obs_log.format_event(
                "bucket", i=b,
                spec=f"{spec.method}/{spec.bits}b/g{g}/r{spec.rank}",
                shape=f"{spec.m}x{spec.n}", layers=len(idxs),
                path=path, shards=spec.n_shards,
                chunks=len(sizes), chunk=max(sizes)))
        if journal is not None:
            hrecs = {}
            if report is not None:
                for i in idxs:
                    sk = health.HealthReport.site_key(tasks[i].path,
                                                      tasks[i].expert)
                    if sk in report.records:
                        hrecs[sk] = report.records[sk]
            journal.commit_bucket(
                b, dataclasses.asdict(spec),
                [[tasks[i].path, tasks[i].expert] for i in idxs],
                [results[i] for i in idxs], health_records=hrecs)
        faults.maybe_kill("kill_between_buckets", b)
        if should_stop is not None and should_stop():
            raise health.QuantPreempted(b)
    return results


def evaluate_layer_batch(tasks: list[LayerTask],
                         base: QuantConfig | None = None,
                         progress: Callable[[str], None] | None = None,
                         *, mesh=None, axis: str = "model",
                         chunk: int | None = None) -> list[float]:
    """Proxy error ``tr(E^T H E)`` of every task, bucket by bucket: the
    engine of the bit allocator's sensitivity sweep
    (:mod:`repro_torch.core.allocate`).

    Tasks carry their *candidate* spec in ``LayerTask.site``; the planner
    (``for_eval=True``) groups them into ``(shape, candidate-spec)``
    buckets, and each bucket runs in chunks of :func:`chunk_size` slices
    (one chunk when it fits the card, always on the CPU; ``chunk`` forces
    that many), one stacked :func:`run_bucket_eval` call each.  Every
    chunk is sized before the first is dispatched, from the memory then
    free: a chunk keeps only its ``(L,)`` errors, so each finds the room
    the one before it had.  The errors stay on the device until every
    chunk has been dispatched; the host waits once, at the end.
    ``progress`` gets one ``[sweep]`` line a bucket, in the JAX twin's
    format (``obs.log.format_event``), and each chunk's call is a
    ``sweep.execute`` span (fenced under ``REPRO_TRACE_SYNC=1``).  With
    ``mesh`` (every rank calling with the same tasks) a divisible bucket
    runs on each rank's columns and all-reduces its errors
    (:func:`run_bucket_eval_sharded`): every rank gets every error.

    Returns one Python float per task, in task order."""
    buckets = plan_buckets(tasks, base=base, mesh=mesh, axis=axis,
                           for_eval=True)
    sizes = [chunk_size(spec, len(idxs), tasks[idxs[0]].W.device, chunk)
             for spec, idxs in buckets.items()]
    order: list[int] = []
    errs: list[Tensor] = []
    with torch.no_grad():
        for b, (spec, idxs) in enumerate(buckets.items()):
            if progress:
                g = "col" if spec.group_size is None else spec.group_size
                progress(obs_log.format_event(
                    "sweep", i=b,
                    spec=f"{spec.method}/{spec.bits}b/g{g}/r{spec.rank}",
                    shape=f"{spec.m}x{spec.n}", candidates=len(idxs),
                    path=("sharded" if spec.n_shards > 1 else "replicated"),
                    shards=spec.n_shards))
            cols = rank_columns(spec, mesh, axis)
            for pos in range(0, len(idxs), sizes[b]):
                cidxs = idxs[pos:pos + sizes[b]]
                staged = _stage_bucket(tasks, cidxs, spec, cols)
                with obs_trace.span("sweep.execute", bucket=b,
                                    candidates=len(cidxs)) as sp:
                    out = (run_bucket_eval_sharded(*staged, spec, mesh, axis)
                           if cols is not None
                           else run_bucket_eval(*staged, spec))
                    errs.append(sp.sync(out))
                del staged
                order.extend(cidxs)
    results: list[float] = [0.0] * len(tasks)
    if errs:
        host = torch.cat([e.reshape(-1) for e in errs]).tolist()
        for i, e in zip(order, host):
            results[i] = e
    return results
