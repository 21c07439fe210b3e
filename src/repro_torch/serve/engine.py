"""Multi-tenant serving engine: continuous batching over one packed base.
Twin of ``repro.serve.engine``.

One :class:`ServeEngine` owns

* the **packed base** param tree (quantized linears; the base's own LoRA
  leaves are stripped at every registry site — adapters come only from
  the :class:`~repro_torch.serve.registry.AdapterRegistry`),
* the paged KV pools (:mod:`repro_torch.serve.kv_cache`), on the device
  and written in place,
* the continuous-batching :class:`~repro_torch.serve.scheduler.Scheduler`,
  and
* ONE decode step per rank bucket.  On a CUDA device each is captured as
  a CUDA graph (:class:`repro_torch.launch.steps.CapturedStep`), one per
  bucket shape as ``jax.jit`` keeps one executable per signature; on the
  CPU it runs eagerly.

Each :meth:`step`: the scheduler admits/retires requests, then every
active rank bucket runs one decode — adapters for the bucket's requests
are gathered from the stacked registry tensors by slot index inside the
step and applied as one batched einsum per site.  KV pages are gathered
to a contiguous per-request view, the new token's KV is scattered back,
and per-request lengths drive positions and masks, so heterogeneous
requests (different tenants, ranks, progress) share one device call.

Every op in the step is row-independent for ``dense`` models and stale
page content gets exactly zero softmax weight, so replaying one request
alone through the same step gives its batched tokens
(``tests/test_torch_serving.py``).  MoE models serve through the same
step (tenants adapt the attention sites; the experts keep the base's
adapters), but capacity-based routing mixes a bucket's rows, so that
oracle holds for ``dense`` only, as in the JAX twin; the MoE dispatch
reads nothing on the host, so its step is captured as well.  Each
:meth:`ServeEngine.step` is a ``serve.step`` span and each bucket's
decode a ``serve.decode`` span inside it (``repro_torch.obs.trace``, as
in the JAX twin).  ``compile_cache=`` is the kernel libraries' store
(:mod:`repro_torch.core.compile_cache`); the JAX twin's persisted decode
executable has no counterpart: a CUDA graph lives in its process.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.launch.steps import CapturedStep, resolve_graph
from repro_torch.models.parallel import LOCAL
from repro_torch.models.transformer import decode_step
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.kv_cache import (PageAllocator, extract_token,
                                        gather_pages, init_pools,
                                        pages_needed, scatter_token)
from repro_torch.serve.registry import AdapterRegistry
from repro_torch.serve.scheduler import Scheduler

Tensor = torch.Tensor

# columns of the per-step schedule tensor (B, 3 + maxp) int32: adapter
# slot, input token, length (position written), then the page table
_AD, _TOK, _LEN, _PT = 0, 1, 2, 3


@dataclasses.dataclass
class _Request:
    rid: int
    tenant: str
    rank: int
    ad_slot: int
    prompt: list
    max_new: int
    eos: int | None
    pos: int = 0                       # tokens fed so far
    out: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0               # first appearance in the active map
    t_first: float = 0.0               # first generated token
    t_finish: float = 0.0

    def next_token(self) -> int:
        # teacher-force the prompt, then feed back the last sample
        return (self.prompt[self.pos] if self.pos < len(self.prompt)
                else self.out[-1])


def splice_adapters(base: dict, stacks: dict, ad_slots: Tensor,
                    sites) -> dict:
    """``base`` with each site's ``lora_a``/``lora_b`` taken from the rank
    bucket's stacks at ``ad_slots``: (L, cap, m, r) -> (L, B, m, r), one
    adapter pair per request.  ``base`` itself is not changed."""
    params = dict(base)
    params["blocks"] = dict(base["blocks"])
    for site in sites:
        keys = site.split(".")
        node = _copy_to(params["blocks"], keys[:-1])
        leaf = dict(node[keys[-1]])
        st = stacks[site]
        leaf["lora_a"] = torch.index_select(st["lora_a"], 1, ad_slots)
        leaf["lora_b"] = torch.index_select(st["lora_b"], 1, ad_slots)
        node[keys[-1]] = leaf
    return params


def _decode_step_fn(cfg, sites: tuple):
    """The serving step for one (model config, site set), as the JAX
    twin's ``_decode_step_fn``: splice the adapters gathered by slot into
    the stripped base, gather the pages, decode with the vector ``idx``,
    scatter the new K/V rows back, argmax over the real vocabulary.

    ``sched`` is the (B, 3 + maxp) int32 schedule: adapter slot, token,
    length, page table.  The pools are written in place; returns the next
    tokens (B,) int32."""

    def step_fn(base, stacks, k_pool, v_pool, sched):
        tokens = sched[:, _TOK:_TOK + 1]
        lengths = sched[:, _LEN]
        page_tables = sched[:, _PT:]
        params = splice_adapters(base, stacks, sched[:, _AD], sites)
        K = gather_pages(k_pool, page_tables)
        V = gather_pages(v_pool, page_tables)
        cache = {"k": K, "v": V, "idx": lengths}
        logits, new_cache = decode_step(params, cfg, cache, tokens,
                                        pctx=LOCAL)
        scatter_token(k_pool, extract_token(new_cache["k"], lengths),
                      page_tables, lengths)
        scatter_token(v_pool, extract_token(new_cache["v"], lengths),
                      page_tables, lengths)
        return torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)

    return step_fn


def _copy_to(node: dict, keys: list[str]) -> dict:
    """Copy nested dicts along a path so splicing never mutates the base."""
    for k in keys:
        node[k] = dict(node[k])
        node = node[k]
    return node


def _strip_adapters(params: dict, sites) -> dict:
    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    for site in sites:
        keys = site.split(".")
        node = _copy_to(out["blocks"], keys[:-1])
        node[keys[-1]] = {k: v for k, v in node[keys[-1]].items()
                          if k not in ("lora_a", "lora_b")}
    return out


class ServeEngine:
    """``use_kernel`` sets ``cfg.quant.use_kernel`` as in the JAX twin.
    ``graph``: capture each rank bucket's decode step as a CUDA graph
    (None: on a CUDA device, not on the CPU; True on the CPU raises).
    ``compile_cache`` (a :class:`~repro_torch.core.compile_cache.
    CompileCache` or a directory): where this process's kernel libraries
    are built and loaded (``kernels.build.use_cache``), kept as
    ``self.compile_cache``; each rank bucket's captured decode counts once
    as its ``unportable``."""

    def __init__(self, params: dict, cfg, registry: AdapterRegistry, *,
                 page_size: int = 8, n_pages: int | None = None,
                 max_len: int = 64, bucket_capacity: int = 4,
                 use_kernel: bool = False, compile_cache=None,
                 graph: bool | None = None):
        self.compile_cache = (None if compile_cache is None
                              else build.use_cache(compile_cache))
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"ServeEngine serves attention-cache families (dense/moe); "
                f"{cfg.family!r} models use the fixed-slot loop in "
                "repro_torch.launch.serve")
        if not cfg.scan_layers:
            raise ValueError("ServeEngine needs scan (stacked-layer) params")
        if cfg.quant is not None:
            cfg = dataclasses.replace(
                cfg, quant=dataclasses.replace(cfg.quant,
                                               use_kernel=use_kernel))
        self.cfg = cfg
        self.registry = registry
        self.bucket_capacity = bucket_capacity
        self.device = params["embed"]["w"].device
        self.graph = resolve_graph(graph, self.device)
        self._page = page_size
        self._maxp = pages_needed(max_len, page_size)
        self.max_len = self._maxp * page_size
        if n_pages is None:
            n_pages = 2 * bucket_capacity * self._maxp + 1
        self._base = _strip_adapters(params, registry.sites())
        hd = cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1))
        self._k_pool, self._v_pool = init_pools(
            cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, hd, cfg.dtype,
            device=self.device)
        self.scheduler = Scheduler({}, PageAllocator(n_pages))
        self._reqs: dict[int, _Request] = {}
        self._next_rid = 0
        self.steps = 0
        self.decodes: dict[int, int] = {}              # rank -> decodes
        self._step_fn = _decode_step_fn(self.cfg,
                                        tuple(self.registry.sites()))
        self._captured: dict[int, CapturedStep] = {}   # rank -> graph

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, tenant: str, max_new: int = 16,
               eos: int | None = None) -> int:
        rank, ad_slot = self.registry.slot_of(tenant)
        self.scheduler.ensure_bucket(rank, self.bucket_capacity)
        prompt = [int(t) for t in prompt]
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        n_tok = len(prompt) + max_new - 1
        if n_tok > self.max_len:
            raise ValueError(f"request needs {n_tok} cache positions, "
                             f"engine max_len is {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._reqs[rid] = _Request(rid, tenant, rank, ad_slot, prompt,
                                   max_new, eos, t_submit=time.perf_counter())
        self.scheduler.submit(rid, rank, pages_needed(n_tok, self._page))
        obs_metrics.counter(obs_names.SERVE_SUBMITTED).inc()
        return rid

    def _decode(self, rank: int, sched: np.ndarray) -> np.ndarray:
        """One decode of a rank bucket: the next tokens, on the host."""
        self.decodes[rank] = self.decodes.get(rank, 0) + 1
        s = torch.from_numpy(sched).to(self.device)
        with torch.no_grad():
            if not self.graph:
                out = self._step_fn(self._base, self.registry.stacks(rank),
                                    self._k_pool, self._v_pool, s)
                return out.cpu().numpy()
            cap = self._captured.get(rank)
            if cap is None:
                stacks = self.registry.stacks(rank)
                cap = self._captured[rank] = CapturedStep(
                    lambda sc: self._step_fn(self._base, stacks,
                                             self._k_pool, self._v_pool, sc))
            return cap(s).cpu().numpy()

    def step(self) -> list[int]:
        """One engine iteration; returns rids finished this step."""
        with obs_trace.span("serve.step", step=self.steps) as step_sp:
            active = self.scheduler.tick()
            now = time.perf_counter()
            queue_hist = obs_metrics.histogram(obs_names.SERVE_QUEUE_WAIT)
            for entries in active.values():
                for _slot, rid in entries:
                    r = self._reqs[rid]
                    if r.t_admit == 0.0:
                        r.t_admit = now
                        queue_hist.observe(now - r.t_submit)
            finished: list[int] = []
            for rank in sorted(b for b, ent in active.items() if ent):
                entries = active[rank]
                sched = np.zeros((self.bucket_capacity, _PT + self._maxp),
                                 np.int32)
                for slot, rid in entries:
                    r = self._reqs[rid]
                    sched[slot, _AD] = r.ad_slot
                    sched[slot, _TOK] = r.next_token()
                    sched[slot, _LEN] = r.pos
                    pages = self.scheduler.pages_of(rid)
                    sched[slot, _PT:_PT + len(pages)] = pages
                with obs_trace.span("serve.decode", rank=rank,
                                    batch=len(entries)):
                    nxt = self._decode(rank, sched)  # host sync inside
                for slot, rid in entries:
                    r = self._reqs[rid]
                    r.pos += 1
                    if r.pos >= len(r.prompt):
                        tok = int(nxt[slot])
                        r.out.append(tok)
                        obs_metrics.counter(obs_names.SERVE_TOKENS).inc()
                        if len(r.out) == 1:
                            r.t_first = time.perf_counter()
                            obs_metrics.histogram(
                                obs_names.SERVE_TTFT).observe(
                                r.t_first - r.t_submit)
                        if len(r.out) >= r.max_new or tok == r.eos:
                            r.t_finish = time.perf_counter()
                            self._retire_metrics(r)
                            self.scheduler.retire(rid)
                            finished.append(rid)
            self._kv_metrics()
            obs_metrics.counter(obs_names.SERVE_STEPS).inc()
            self.steps += 1
            step_sp.set(finished=len(finished))
        return finished

    def _retire_metrics(self, r: _Request) -> None:
        obs_metrics.counter(obs_names.SERVE_FINISHED).inc()
        if len(r.out) > 1:
            obs_metrics.histogram(obs_names.SERVE_TOKEN_LATENCY).observe(
                (r.t_finish - r.t_first) / (len(r.out) - 1))

    def _kv_metrics(self) -> None:
        alloc = self.scheduler.allocator
        in_use = alloc.n_usable - alloc.n_free
        obs_metrics.gauge(obs_names.SERVE_KV_PAGES_IN_USE).set(in_use)
        obs_metrics.gauge(obs_names.SERVE_KV_PAGES_TOTAL).set(alloc.n_usable)
        obs_metrics.histogram(obs_names.SERVE_KV_OCCUPANCY).observe(
            in_use / alloc.n_usable)

    def run(self, max_steps: int | None = None) -> dict[int, list[int]]:
        """Drive until every submitted request retires."""
        if max_steps is None:
            max_steps = self.scheduler.outstanding() * (self.max_len + 2) + 4
        for _ in range(max_steps):
            if not self.scheduler.outstanding():
                break
            self.step()
        if self.scheduler.outstanding():
            raise RuntimeError("scheduler failed to drain the queue "
                               f"within {max_steps} steps")
        return {rid: list(r.out) for rid, r in self._reqs.items() if r.out}

    # -- views -------------------------------------------------------------

    def result(self, rid: int) -> list[int]:
        return list(self._reqs[rid].out)

    def latency(self, rid: int) -> float:
        r = self._reqs[rid]
        return r.t_finish - r.t_submit


def run_workload(engine: ServeEngine, requests, *,
                 sequential: bool = False) -> dict[int, list[int]]:
    """Serve ``[(tenant, prompt, max_new), ...]``; returns {i: tokens}.

    ``sequential=True`` is the parity reference: one request in flight at
    a time through the SAME engine and steps."""
    outs: dict[int, list[int]] = {}
    if sequential:
        for i, (tenant, prompt, max_new) in enumerate(requests):
            rid = engine.submit(prompt, tenant, max_new)
            engine.run()
            outs[i] = engine.result(rid)
    else:
        rids = [engine.submit(prompt, tenant, max_new)
                for tenant, prompt, max_new in requests]
        engine.run()
        outs = {i: engine.result(rid) for i, rid in enumerate(rids)}
    return outs
