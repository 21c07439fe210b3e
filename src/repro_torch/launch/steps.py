"""Step builders shared by the launchers and the dry run.  Twin of
``repro.launch.steps``.

``make_train_step`` builds the LoRA fine-tuning step: frozen quantized base
plus trainable adapters, AdamW and an LR schedule, with optional
microbatch gradient accumulation.  Gradients come from
``torch.autograd.grad`` on the trainable leaves only.

Given a meshed ``PContext`` (``launch.mesh.pcontext_for``) the step is the
twin's ``jax.jit(make_train_step(...), in_shardings=named(state_pspecs(...)))``
written SPMD: the state's leaves are DTensors of their ``param_specs``
layouts (``checkpoint.restore_tree(shardings=named(state_pspecs(...)))``),
each rank takes its rows of the global batch (``batch_pspecs``), the model
computes on its local shards with its own collectives
(``models.parallel``), every trainable gradient is summed over the data
axes (one all-reduce: each data rank differentiates its share of the
global loss), the clip's norm counts each sharded leaf once across its
shards, and the metrics are the same on every rank.  ``make_decode_step``
runs the sharded decode the same way (eagerly: a gloo collective cannot
be captured in a CUDA graph).

:class:`CapturedStep` is the port's counterpart of ``jax.jit`` for a
decode step on the card: the step captured once as a CUDA graph and
replayed, so that the host issues one launch a step instead of every
operator's.

The dry run's builders (``SHAPE_CELLS``, ``cell_applicable``,
``batch_specs``, ``abstract_params``/``abstract_state``/``abstract_cache``)
give trees of meta tensors: the twin's ``ShapeDtypeStruct`` trees, nothing
allocated (``launch/dryrun.py`` runs a rank's step on them).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.pipeline import data_kind, make_batch_specs, shard_batch
from repro_torch.kernels import build, ops
from repro_torch.launch.shardings import param_specs, to_named
from repro_torch.models import parallel
from repro_torch.models.parallel import LOCAL, PContext
from repro_torch.models.transformer import (ModelConfig, check_family,
                                            decode_step, forward,
                                            init_decode_cache, init_params,
                                            loss_fn)
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               make_schedule, merge_params, partition_params,
                               trainable_mask, tree_leaves, tree_map)
from repro_torch.utils import set_path, tree_paths

SHAPE_CELLS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# quantized/structural leaves never trained even in "all" mode
_NEVER_TRAIN = ("qcodes", "scales", "zeros", "absmax")


def cell_applicable(cfg: ModelConfig, cell: str) -> tuple[bool, str]:
    """Whether the dry run lowers ``cell`` for ``cfg``, and why not (the
    twin's reason, word for word)."""
    if cell == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full-attention arch: 500k decode needs sub-quadratic "
                       "attention (skip per assignment; DESIGN.md §5)")
    return True, ""


def full_trainable_mask(params, mode: str):
    mask = trainable_mask(params, mode)
    out: dict = {}
    for pth, m in tree_paths(mask).items():
        if pth.rsplit(".", 1)[-1] in _NEVER_TRAIN:
            m = False
        set_path(out, pth, m)
    return out


def build_state(params, ocfg: OptConfig) -> dict:
    mask = full_trainable_mask(params, ocfg.trainable)
    train_p, frozen_p = partition_params(params, mask)
    return {"train": train_p, "frozen": frozen_p, "opt": adamw_init(train_p)}


def _device_of(tree) -> torch.device:
    for leaf in tree_leaves(tree):
        if leaf.numel():
            return leaf.device
    return torch.device("cpu")


def state_pspecs(state_shapes, mesh=None) -> dict:
    """Layouts of a train state (``build_state``'s tree, or its shapes):
    the params' and the moments' by :func:`param_specs`, the step
    replicated."""
    return {"train": param_specs(state_shapes["train"], mesh),
            "frozen": param_specs(state_shapes["frozen"], mesh),
            "opt": {"mu": param_specs(state_shapes["opt"]["mu"], mesh),
                    "nu": param_specs(state_shapes["opt"]["nu"], mesh),
                    "step": ()}}


def batch_pspecs(cfg: ModelConfig, batch, data_axes) -> dict:
    """Layouts of a batch's leaves: the batch dim over the data axes unless
    it is 1.  ``batch`` is a batch (tensors or shapes) or, as in the twin,
    the name of a shape cell (:data:`SHAPE_CELLS`)."""
    if isinstance(batch, str):
        batch = batch_specs(cfg, batch)
    specs = make_batch_specs(data_kind(cfg), data_axes)
    out = {}
    for name, leaf in batch.items():
        nd = len(leaf.shape)
        bspec = specs.get(name, (data_axes,))[0] if leaf.shape[0] > 1 \
            else None
        out[name] = (bspec,) + (None,) * (nd - 1)
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: str) -> dict:
    """One input batch of shape cell ``cell`` as meta tensors: int32
    tokens (and labels for a train cell), an enc-dec model's f32
    ``enc_embeds`` (a quarter of the sequence), a vision model's f32
    ``prefix_embeds`` before its text tokens; a decode cell's (B, 1)
    tokens."""
    c = SHAPE_CELLS[cell]
    B, S = c["batch"], c["seq"]
    i32 = torch.int32
    if c["kind"] == "decode":
        return {"tokens": _meta((B, 1), i32)}
    if cfg.family == "encdec":
        batch = {"tokens": _meta((B, S), i32),
                 "enc_embeds": _meta((B, S // 4, cfg.d_model),
                                     torch.float32)}
    elif cfg.frontend == "vision":
        batch = {"tokens": _meta((B, S - cfg.n_prefix), i32),
                 "prefix_embeds": _meta((B, cfg.n_prefix, cfg.d_model),
                                        torch.float32)}
    else:
        batch = {"tokens": _meta((B, S), i32)}
    if c["kind"] == "train":
        batch["labels"] = _meta(tuple(batch["tokens"].shape), i32)
    return batch


def abstract_params(cfg: ModelConfig, recipe=None) -> dict:
    """The param tree as meta tensors: dense when ``cfg.quant`` is unset,
    else the quantized layout (``core.pipeline.quantized_param_shapes``),
    per site when a ``QuantRecipe`` is given."""
    from repro_torch.core.pipeline import quantized_param_shapes
    if recipe is not None:
        return quantized_param_shapes(cfg, recipe=recipe)
    if cfg.quant is not None:
        return quantized_param_shapes(cfg)
    return init_params(cfg, device="meta")


def abstract_state(cfg: ModelConfig, ocfg: OptConfig, recipe=None) -> dict:
    """:func:`build_state` of :func:`abstract_params`: meta tensors."""
    return build_state(abstract_params(cfg, recipe), ocfg)


def abstract_cache(cfg: ModelConfig, cell: str, kv_dtype=None) -> dict:
    """The decode cache of shape cell ``cell`` as meta tensors (its K/V in
    ``kv_dtype`` when given)."""
    c = SHAPE_CELLS[cell]
    return init_decode_cache(cfg, c["batch"], c["seq"], dtype=kv_dtype,
                             device="meta")


def named(tree, mesh):
    """A tree of layouts as ``NamedSharding`` s on ``mesh`` (what
    ``checkpoint.restore_tree(shardings=)`` takes)."""
    return to_named(tree, mesh)


def _live(t: torch.Tensor) -> torch.Tensor:
    """A fresh leaf for autograd, keeping ``t``'s layout tag."""
    return parallel.tag(t.detach().requires_grad_(True),
                        parallel.layout_of(t))


def _value_and_grad(cfg: ModelConfig, pctx: PContext, train: dict,
                    frozen: dict, batch: dict):
    """(loss, ce, aux), grads of ``train`` (each in its leaf's dtype; a leaf
    the loss does not reach gets zeros).  Under a mesh: the rank's
    gradients of the global loss, before the sum over the data axes."""
    live = tree_map(_live, train)
    with torch.enable_grad():
        loss, (ce, aux) = loss_fn(merge_params(live, frozen), cfg, batch,
                                  pctx=pctx)
        leaves = tree_leaves(live)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g)
             for t, g in zip(leaves, gs)}
    grads = tree_map(lambda t: by_id[id(t)], live)
    return (loss.detach(), ce.detach(), aux.detach()), grads


def sum_over_data(grads, pctx: PContext):
    """``grads`` summed over the data axes of ``pctx``: every leaf in one
    flat f32 all-reduce an axis."""
    axes = [ax for ax in parallel.data_axis_tuple(pctx)
            if parallel.axis_size(pctx.mesh, ax) > 1]
    leaves = tree_leaves(grads)
    if not axes or not leaves:
        return grads
    flat = torch.cat([g.float().reshape(-1) for g in leaves])
    for ax in axes:
        flat = parallel.all_reduce_sum(flat, parallel.axis_group(pctx.mesh,
                                                                 ax))
    at = [0]

    def take(g):
        n = g.numel()
        at[0] += n
        return flat[at[0] - n:at[0]].view(g.shape).to(g.dtype)
    return tree_map(take, grads)


def value_and_grad(cfg: ModelConfig, pctx: PContext, state: dict,
                   batch: dict, *, sync: bool = True):
    """((loss, ce, aux), grads) of a train state on one batch, as the
    step computes them before the optimizer: under a mesh the state's
    DTensors in, the global batch read by rows, and the rank's shards of
    the gradients of the global loss out, summed over the data axes
    (``sync=False``: the rank's own share, before that sum)."""
    loc = parallel.localize(state)
    dev = _device_of(loc["frozen"])
    batch = _batch_rows(cfg, pctx, batch, dev)
    vals, grads = _value_and_grad(cfg, pctx, loc["train"], loc["frozen"],
                                  batch)
    if pctx.mesh is not None and sync:
        grads = sum_over_data(grads, pctx)
    return vals, grads


def _batch_rows(cfg: ModelConfig, pctx: PContext, batch: dict,
                dev: torch.device) -> dict:
    """The rank's rows of a global batch (all of it without a mesh), on
    ``dev``."""
    batch = {n: torch.as_tensor(v) for n, v in batch.items()}
    if pctx.mesh is not None:
        batch = shard_batch(batch, batch_pspecs(cfg, batch, pctx.data_axes),
                            pctx.mesh)
    return {n: v.to(dev) for n, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    pctx: PContext = LOCAL):
    """step(state, batch) -> (new_state, metrics).  ``batch`` holds
    ``tokens``/``labels`` (B, S) on any device; they are moved to the
    params' device.  With ``ocfg.microbatch`` = k > 1 the batch is split
    into k microbatches along B whose f32 gradients and losses are
    averaged; the backward of one ends before the next starts.  Under
    ``pctx.mesh`` (the module docstring) the state holds DTensors and
    ``batch`` is the global batch (an enc-dec model's ``enc_embeds`` and
    a vision model's ``prefix_embeds`` split over the data axes with the
    tokens)."""
    check_family(cfg)
    schedule = make_schedule(ocfg.schedule, ocfg.lr, ocfg.total_steps,
                             ocfg.warmup_frac)
    k = max(ocfg.microbatch, 1)

    def train_step(state, batch):
        loc = parallel.localize(state) if pctx.mesh is not None else state
        dev = _device_of(loc["frozen"])
        batch = _batch_rows(cfg, pctx, batch, dev)
        if k > 1:
            acc = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                 device=t.device),
                           loc["train"])
            sums = [torch.zeros((), dtype=torch.float32, device=dev)
                    for _ in range(3)]
            for i in range(k):
                b = {n: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                     for n, v in batch.items()}
                vals, g = _value_and_grad(cfg, pctx, loc["train"],
                                          loc["frozen"], b)
                acc = tree_map(lambda a, gi: a + gi, acc, g)
                sums = [s + v.float() for s, v in zip(sums, vals)]
            grads = tree_map(lambda a: a / k, acc)
            loss, ce, aux = (s / k for s in sums)
        else:
            (loss, ce, aux), grads = _value_and_grad(
                cfg, pctx, loc["train"], loc["frozen"], batch)
        group = sharded = None
        if pctx.mesh is not None:
            grads = sum_over_data(grads, pctx)
            sharded = tree_map(parallel.model_sharded, loc["train"])
            if parallel.axis_size(pctx.mesh, pctx.model_axis) > 1:
                group = parallel.axis_group(pctx.mesh, pctx.model_axis)
        with torch.no_grad():
            new_tp, new_opt, m = adamw_update(
                grads, loc["opt"], loc["train"], ocfg, schedule,
                group=group, sharded=sharded)
        if pctx.mesh is not None:
            new_tp = parallel.delocalize(new_tp, loc["train"])
            new_opt = parallel.delocalize(new_opt, loc["opt"])
        metrics = {"loss": loss, "ce": ce, "aux": aux, **m}
        return {"train": new_tp, "frozen": state["frozen"],
                "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, pctx: PContext = LOCAL,
                      last_only: bool = False):
    """prefill(params, batch) -> logits (B, S, V), or (B, 1, V) of the last
    position with ``last_only`` (the (B, S, V) logits are waste when the
    prefill feeds a decode loop).  Under ``pctx.mesh`` the params are
    DTensors, ``batch`` the global batch, and the logits the rank's rows
    over the whole vocab."""
    check_family(cfg)

    def prefill(params, batch):
        if pctx.mesh is not None:
            params = parallel.localize(params)
        batch = _batch_rows(cfg, pctx, batch, _device_of(params))
        if last_only:
            from repro_torch.models.modules import lm_head_apply
            from repro_torch.models.transformer import _whole_vocab
            hidden, _ = forward(params, cfg, batch, pctx=pctx,
                                return_hidden=True)
            head = params.get("head", params["embed"])
            return _whole_vocab(head, lm_head_apply(head,
                                                    hidden[:, -1:, :]))
        logits, _ = forward(params, cfg, batch, pctx=pctx)
        return logits

    return prefill


def _cache_batch(cache: dict, pctx: PContext):
    """(the batch dim's layout entry, the device) of a sharded decode
    cache: read from its first leaf sharded over a data axis (None: the
    batch whole on every rank)."""
    data = set(parallel.data_axis_tuple(pctx))
    dev = None
    for leaf in tree_leaves(cache):
        dev = dev or parallel.local_of(leaf).device
        if not parallel.is_sharded(leaf):
            continue
        for ax in parallel.spec_of_placements(leaf.placements,
                                              leaf.device_mesh, leaf.dim()):
            axes = parallel.entry_axes(ax)
            if axes and all(a in data for a in axes):
                return ax, parallel.local_of(leaf).device
    return None, dev


def make_decode_step(cfg: ModelConfig, pctx: PContext):
    """step(params, cache, tokens) -> (logits (B, V), cache).  Under
    ``pctx.mesh``: the cache from ``init_decode_cache(pctx=)``, ``tokens``
    the global batch's, each rank decoding its rows of the cache's batch
    with its KV heads, SSM state heads and conv channels, and the logits
    the global batch's on every rank."""
    check_family(cfg)
    if pctx.mesh is None:
        def step(params, cache, tokens):
            return decode_step(params, cfg, cache, tokens, pctx=pctx)
        return step

    def sharded_step(params, cache, tokens):
        bspec, dev = _cache_batch(cache, pctx)
        tokens = torch.as_tensor(tokens).to(dev)
        rows = shard_batch({"tokens": tokens}, {"tokens": (bspec, None)},
                           pctx.mesh)["tokens"]
        logits, cache = decode_step(params, cfg, cache, rows, pctx=pctx)
        for ax in (() if bspec is None else (bspec,) if isinstance(bspec, str)
                   else tuple(bspec))[::-1]:
            logits = parallel.gather_from(logits,
                                          parallel.axis_group(pctx.mesh, ax),
                                          0, reduce_grad=False)
        return logits, cache

    return sharded_step


def resolve_graph(graph: bool | None, device: torch.device) -> bool:
    """Whether a decode step runs as a :class:`CapturedStep`: ``graph``,
    or on a CUDA device when None.  True on another device raises."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("graph=True needs a CUDA device (on the CPU the "
                         "step runs eagerly)")
    return graph


def _tensors(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


class CapturedStep:
    """``fn(*inputs)`` captured as one CUDA graph over static input buffers.

    The first call runs ``fn`` eagerly on a side stream (the libraries'
    and kernels' first-use set-up happens there) and returns its outputs.  The next call captures ``fn`` on that stream over copies of
    its inputs, and it and every later call copy their inputs into those
    buffers and replay the graph.  What a replay returns is the graph's
    static outputs: the next call overwrites them, so the caller reads or
    copies them out before it.  Everything else ``fn`` reads (params,
    caches, KV pools, adapter stacks) is captured at its address: it must
    stay there, and may be written in place between calls.

    Inputs are CUDA tensors that keep their shapes and dtypes from call to
    call.  The kernels' launch counters count a replay as the launches
    captured in the graph (``ops.captured_launches``, ``ops.add_replayed``).
    A failed capture or replay raises; nothing falls back to the eager
    step.  A failed capture first hands its memory pool back to the
    caching allocator and the caller's stream back to the caller
    (:meth:`_abandon`).  ``launches`` holds the captured launches once
    captured.  A capture counts once as the compile cache's
    ``unportable`` (``kernels.build.active_cache``): a graph lives in its
    process."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.warmup = 1         # eager calls before the capture
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: tuple[torch.Tensor, ...] = ()
        self.outputs = None
        self.launches: dict[str, int] = {}
        self._stream: torch.cuda.Stream | None = None

    def __call__(self, *inputs: torch.Tensor):
        if not inputs or not all(isinstance(t, torch.Tensor) and t.is_cuda
                                 for t in inputs):
            raise ValueError("CapturedStep takes CUDA tensors; on the CPU "
                             "the step runs eagerly")
        dev = inputs[0].device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self.graph is None and self.calls < self.warmup:
            self.calls += 1
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out = self.fn(*inputs)
            cur.wait_stream(self._stream)
            for t in _tensors(out):
                t.record_stream(cur)
            return out
        if self.graph is None:
            self._capture(inputs)
        else:
            for buf, t in zip(self.inputs, inputs, strict=True):
                if buf.shape != t.shape or buf.dtype != t.dtype:
                    raise ValueError(
                        f"CapturedStep: input {tuple(t.shape)} {t.dtype} "
                        f"does not match the captured {tuple(buf.shape)} "
                        f"{buf.dtype}")
                buf.copy_(t, non_blocking=True)
        self.graph.replay()
        ops.add_replayed(self.launches)
        self.calls += 1
        return self.outputs

    def _capture(self, inputs: tuple[torch.Tensor, ...]) -> None:
        self.inputs = tuple(t.clone() for t in inputs)
        g = torch.cuda.CUDAGraph()
        # the graph's memory pool, named here: a graph whose capture failed
        # will not tell its own (CUDAGraph.pool raises)
        pool = torch.cuda.graph_pool_handle()
        capture = torch.cuda.graph(g, pool=pool, stream=self._stream)
        try:
            with ops.captured_launches() as launched:
                with capture:
                    self.outputs = self.fn(*self.inputs)
        except BaseException:
            self.outputs = None
            # torch.cuda.graph's exit ends the capture before it leaves its
            # stream: when ending it raised, the caller's stream is still
            # ours, and the allocator still sends this stream's blocks to
            # the graph's pool, which nothing would ever free
            if torch.cuda.current_stream(self._stream.device) == self._stream:
                self._abandon(pool, capture, self._stream.device.index)
            raise
        self.graph, self.launches = g, launched
        cache = build.active_cache()
        if cache is not None:       # a graph is never written to the cache
            cache.count_unportable()

    @staticmethod
    def _abandon(pool, capture, device: int) -> None:
        """What a failed ``capture_end`` leaves undone: the graph's private
        memory ``pool`` ended and released (torch's private API; a torch
        without it raises), and the stream context that ``capture`` (a
        ``torch.cuda.graph``) entered left."""
        try:
            for name in ("_cuda_endAllocateToPool", "_cuda_releasePool"):
                if not hasattr(torch._C, name):
                    raise RuntimeError(
                        f"CapturedStep: this torch has no torch._C.{name}, so "
                        "a failed capture cannot hand back its memory pool")
            torch._C._cuda_endAllocateToPool(device, pool)
            torch._C._cuda_releasePool(device, pool)
        finally:
            capture.stream_ctx.__exit__(None, None, None)
