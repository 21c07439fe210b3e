"""Serving CLI: quantize a model, then serve it greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --max-new 16 --batch 4 --cache-len 128 \\
        --tenants 4 --ranks 64,16 [--adapter NAME=DIR]

``--arch``: the dense ``qwen3-1.7b``, ``qwen3-4b``, ``codeqwen1.5-7b`` and
``minicpm-2b``, the MoE ``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b``, the SSM
``mamba2-370m``, the hybrid ``zamba2-7b``, the enc-dec
``seamless-m4t-medium`` or the vision-prefix ``pixtral-12b``
(``repro_torch.configs``).

Twin of ``repro.launch.serve``: the same flags plus ``--device`` (CUDA
unless ``--device cpu``).  It quantizes as the JAX CLI does, through
``quantize_model``'s batched engine with any ``--method`` (calibration on
2 x 64 tokens, with 16 encoder frames or ``n_prefix`` patches where the
model reads them; group 64 and rank 64 at full size, 16 and 8 with
``--smoke``), and routes as it does:

* a dense or MoE scan model with LoRA adapter sites (every quantized
  one; a MoE model's tenants adapt its attention, its experts keep the
  base's CLoQ adapters) is served by the multi-tenant
  :class:`repro_torch.serve.ServeEngine`:
  ``--tenants`` synthetic tenants over the ``--ranks`` buckets (the JAX
  CLI's ``synthesize_adapters``), plus one tenant per ``--adapter
  NAME=DIR`` loaded from a checkpoint (the train CLI's ``--ckpt-dir``),
  ``--batch`` slots a rank bucket, a paged KV cache of ``--page-size``
  tokens a page; the summary is read from the metrics registry;
* an SSM, hybrid or enc-dec model, and a model without adapter sites
  (``--method none``), is served by the fixed-slot refill loop
  (:func:`serve_fixed_slots`), whose conv windows, SSM states and K/V
  rings are written in place each step; an enc-dec model decodes against
  an ``enc_out`` of zeros, as in the JAX CLI (the text-only decode of a
  speech model with no audio).

On a CUDA device the quantized linears and decode attention run through
the hand-written kernels (``QSpec.use_kernel``), and each decode step is
captured as a CUDA graph and replayed
(:class:`repro_torch.launch.steps.CapturedStep`); on the CPU the kernels
take their plain versions only with ``--kernel``, and steps run eagerly.
``--trace-out FILE`` writes a chrome-trace span timeline (the
quantization's buckets, ``serve.step``, ``serve.admit``,
``serve.decode``) and ``--metrics-out FILE`` the metrics snapshot
(``results/metrics-serve.json`` when only ``--trace-out`` is given), as
the JAX CLI does (``repro_torch.obs``).  ``--cost-cal FILE`` plans the
quantization buckets with the cost model.  ``--compile-cache DIR`` is the
directory the CUDA kernel libraries are built into and loaded from
(``repro_torch.core.compile_cache``); with it the CLI prints the JAX CLI's
``[serve] decode cache_hits=... cache_misses=...`` line, plus
``cache_corrupt``, ``cache_unportable`` (the rank buckets' captured
graphs), the kernel ``libraries`` loaded and each kernel's ``launches``
(replays of captured graphs included).  ``--tokens-out FILE`` writes
each request's tokens (the engine route) or each step's (the fixed-slot
loop) as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe, load_plan
from repro_torch.data import DataConfig, TokenStream, data_kind
from repro_torch.kernels import build, ops
from repro_torch.launch.steps import (CapturedStep, make_decode_step,
                                      resolve_graph)
from repro_torch.models.modules import QSpec
from repro_torch.models.parallel import LOCAL
from repro_torch.models.transformer import init_decode_cache, init_params
from repro_torch import obs
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.serve import (AdapterRegistry, ServeEngine,
                               adapters_from_tree)
from repro_torch.serve.registry import synthesize_adapters
from repro_torch.utils import resolve_device

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--method", default="cloq")
    p.add_argument("--recipe", default="",
                   help="QuantRecipe JSON, or a bucket-manifest JSON "
                        "embedding one; overrides --method/--bits")
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--batch", type=int, default=4,
                   help="slots per rank bucket (fixed-slot loop: slot "
                        "count)")
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tenants", type=int, default=0,
                   help="synthetic tenants (0 = batch x #ranks)")
    p.add_argument("--ranks", default="",
                   help="comma list of adapter ranks, one bucket each "
                        "(default: the base recipe's rank)")
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--adapter", action="append", default=[],
                   metavar="NAME=DIR",
                   help="load a tenant adapter checkpoint (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--kernel", action="store_true",
                   help="route quantized linears and decode attention "
                        "through the kernel wrappers (always on for CUDA)")
    p.add_argument("--trace-out", default="", metavar="FILE",
                   help="write a chrome-trace/Perfetto span timeline "
                        "(quantize buckets + serve steps/decodes) to FILE; "
                        "REPRO_TRACE_SYNC=1 fences the CUDA work")
    p.add_argument("--metrics-out", default="", metavar="FILE",
                   help="write the metrics-registry snapshot to FILE "
                        "(defaults to results/metrics-serve.json when "
                        "--trace-out is set)")
    p.add_argument("--cost-cal", default="", metavar="FILE",
                   help="cost-model calibration JSON (repro_torch.core."
                        "costmodel.calibrate output) driving the bucket "
                        "planner's sharded/replicated/sequential choice")
    p.add_argument("--compile-cache", default="", metavar="DIR",
                   help="directory the CUDA kernel libraries are built "
                        "into and loaded from (default build/repro_torch; "
                        "repro_torch.core.compile_cache)")
    p.add_argument("--tokens-out", default="", metavar="FILE",
                   help="write the generated tokens as JSON to FILE")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_quantized(args, cfg, params):
    """Quantize ``params`` as the JAX CLI does.  Returns (cfg, params)."""
    recipe = None
    if args.recipe:
        recipe = load_plan(args.recipe)
    elif args.method != "none":
        recipe = QuantRecipe.single(
            args.method,
            QSpec(bits=args.bits, group_size=16 if args.smoke else 64,
                  rank=8 if args.smoke else 64, method=args.method))
    if recipe is not None:
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2,
                          seed=args.seed, kind=data_kind(cfg), enc_len=16,
                          n_prefix=cfg.n_prefix, d_model=cfg.d_model)
        calib = [TokenStream(dcfg).next_batch()]
        params, cfg, _ = quantize_model(
            params, cfg, calib, recipe=recipe,
            cost_model=args.cost_cal or None)
    return cfg, params


def serve_fixed_slots(params, cfg, *, batch: int, cache_len: int,
                      requests: int, max_new: int, seed: int,
                      device: str | torch.device,
                      keep_logits: bool = False,
                      graph: bool | None = None,
                      enc_out: torch.Tensor | None = None) -> dict:
    """Fixed-slot refill loop: ``batch`` slots, each serving one request
    of ``max_new`` greedy tokens from a random first token, refilled as
    requests finish.  The KV cache position advances every step and is
    never rewound, so the run needs ``ceil(requests / batch) * max_new <=
    cache_len`` (checked up front).  ``graph``: capture the decode step as
    a CUDA graph (None: on CUDA, not on the CPU).  ``enc_out``: an enc-dec
    model's encoder output ``(batch, cache_len, d_model)`` to decode
    against (default: the cache's zeros, as the CLI serves).  Returns counts, times
    (each step's host seconds in ``step_s``: a step ends by reading its
    tokens, a sync), the per-step input and output tokens, whether every
    logit was finite, and (``keep_logits``) the per-step logits on the
    CPU."""
    B = batch
    device = torch.device(device)
    if -(-requests // B) * max_new > cache_len:
        raise ValueError(
            f"{requests} requests x {max_new} tokens in {B} slots take "
            f"{-(-requests // B) * max_new} steps, more than --cache-len "
            f"{cache_len}")
    cache = init_decode_cache(cfg, B, cache_len, device=device)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    decode = make_decode_step(cfg, LOCAL)

    def step(inp):
        # inp (B + 1,) int32: the slots' tokens, then the cache position
        logits, _ = decode(params, dict(cache, idx=inp[B]), inp[:B, None])
        return logits

    if resolve_graph(graph, device):
        step = CapturedStep(step)

    rng = np.random.default_rng(seed)
    queue = [int(rng.integers(1, cfg.vocab)) for _ in range(requests)]
    slots = [None] * B             # [request_id, tokens_left] or None
    current = np.zeros((B + 1,), np.int32)
    done, req_id, steps = 0, 0, 0
    inputs, outputs, logits_kept, step_s = [], [], [], []
    finite = torch.ones((), dtype=torch.bool, device=device)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        while done < requests:
            for s in range(B):          # refill free slots
                if slots[s] is None and queue:
                    slots[s] = [req_id, max_new]
                    current[s] = queue.pop(0)
                    req_id += 1
            inputs.append(current[:B].copy())
            current[B] = steps
            ts = time.perf_counter()
            logits = step(torch.from_numpy(current).to(device))
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(dim=-1).cpu().numpy()
            step_s.append(time.perf_counter() - ts)
            outputs.append(nxt)
            if keep_logits:
                logits_kept.append(logits.float().cpu().numpy())
            steps += 1
            for s in range(B):
                if slots[s] is None:
                    continue
                slots[s][1] -= 1
                current[s] = int(nxt[s]) % cfg.vocab
                if slots[s][1] <= 0:
                    done += 1
                    slots[s] = None
            if steps > requests * max_new + 16:
                break
    _sync(device)
    dt = time.perf_counter() - t0
    return {"requests_done": done, "steps": steps, "slot_tokens": steps * B,
            "seconds": dt, "tok_s": steps * B / dt, "step_s": step_s,
            "all_finite": bool(finite), "inputs": inputs,
            "outputs": outputs, "logits": logits_kept}


def build_registry(args, params) -> tuple[AdapterRegistry | None, list]:
    """The JAX CLI's tenants: ``--tenants`` synthetic adapter sets (0: one
    a slot of each bucket) round-robin over the ``--ranks`` buckets (the
    base's rank when empty), seeds ``--seed + i``, then one tenant per
    ``--adapter NAME=DIR`` loaded from its checkpoint.  Returns (registry,
    tenant names), or (None, []) for a model with no adapter sites."""
    base_ad = adapters_from_tree(params)
    if not base_ad:
        return None, []
    registry = AdapterRegistry.from_model(params, capacity=args.batch)
    ranks = ([int(r) for r in args.ranks.split(",") if r]
             or [next(iter(base_ad.values()))["lora_a"].shape[2]])
    n_tenants = args.tenants or args.batch * len(ranks)
    tenants = []
    for i in range(n_tenants):
        name = f"tenant-{i}"
        registry.register(name, synthesize_adapters(
            base_ad, ranks[i % len(ranks)], seed=args.seed + i))
        tenants.append(name)
    for spec in args.adapter:
        name, _, directory = spec.partition("=")
        registry.load(name, directory)
        tenants.append(name)
    return registry, tenants


def _serve_counters() -> dict[str, int]:
    reg = obs_metrics.get_registry()
    return {n: reg.counter(n).value
            for n in (obs_names.SERVE_SUBMITTED, obs_names.SERVE_FINISHED,
                      obs_names.SERVE_TOKENS, obs_names.SERVE_STEPS)}


def serve_engine(engine: ServeEngine, tenants: list, *, requests: int,
                 max_new: int, seed: int) -> dict:
    """The JAX CLI's multi-tenant route on ``engine``: request i is one
    random first token for tenant ``i % len(tenants)``, ``max_new`` greedy
    tokens, all submitted at once.  Returns each request's tenant and
    tokens and the summary: counts read from the metrics registry (this
    run's increments), tokens/s, the bucket decodes of this run (each of
    ``bucket_capacity`` slots: ``slot_tokens``), each engine step's host
    seconds (``step_s``; a step ends by reading its tokens, a sync) and
    bucket decodes (``step_decodes``), and the median request latency."""
    if max_new > engine.max_len:
        raise ValueError(f"a request of {max_new} tokens needs {max_new} "
                         f"cache positions, more than --cache-len "
                         f"{engine.max_len}")
    rng = np.random.default_rng(seed)
    before, dec0 = _serve_counters(), dict(engine.decodes)
    step_s, step_decodes = [], []
    _sync(engine.device)
    t0 = time.perf_counter()
    rids = [engine.submit([int(rng.integers(1, engine.cfg.vocab))],
                          tenants[i % len(tenants)], max_new)
            for i in range(requests)]
    limit = engine.scheduler.outstanding() * (engine.max_len + 2) + 4
    while engine.scheduler.outstanding():
        if len(step_s) >= limit:
            raise RuntimeError("scheduler failed to drain the queue "
                               f"within {limit} steps")
        n0 = sum(engine.decodes.values())
        ts = time.perf_counter()
        engine.step()
        step_s.append(time.perf_counter() - ts)
        step_decodes.append(sum(engine.decodes.values()) - n0)
    _sync(engine.device)
    dt = time.perf_counter() - t0
    after = _serve_counters()
    got = {n: after[n] - before[n] for n in after}
    toks = got[obs_names.SERVE_TOKENS]
    decodes = {r: n - dec0.get(r, 0) for r, n in engine.decodes.items()}
    slots = sum(decodes.values()) * engine.bucket_capacity
    lats = sorted(engine.latency(r) for r in rids)
    return {"route": "engine",
            "requests_done": got[obs_names.SERVE_FINISHED],
            "requests": got[obs_names.SERVE_SUBMITTED],
            "steps": got[obs_names.SERVE_STEPS], "tokens": toks,
            "seconds": dt, "tok_s": toks / dt, "decodes": decodes,
            "slot_tokens": slots, "slot_tok_s": slots / dt,
            "step_s": step_s, "step_decodes": step_decodes,
            "tenants": len(tenants),
            "rank_buckets": engine.registry.ranks(),
            "p50_ms": lats[len(lats) // 2] * 1e3,
            "tenant_of": [tenants[i % len(tenants)]
                          for i in range(requests)],
            "outputs": [engine.result(r) for r in rids]}


def run(args, cfg=None) -> dict:
    """Build, quantize and serve as the CLI does.  ``cfg`` overrides the
    config chosen from ``--arch``/``--smoke`` (e.g. a depth-cut one).
    Decode steps are captured as CUDA graphs on a CUDA device.  Returns
    the quantized ``params``/``cfg``, ``quantize_s``, the ``route``
    ("engine" or "fixed_slots"), the ``registry``, ``tenants`` and
    ``engine`` of the engine route and the ``serve`` summary of
    :func:`serve_engine` or :func:`serve_fixed_slots`."""
    if args.compile_cache:
        build.use_cache(args.compile_cache)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    params = init_params(cfg, seed=args.seed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    cfg, params = build_quantized(args, cfg, params)
    _sync(device)
    quantize_s = time.perf_counter() - t0
    use_kernel = device.type == "cuda" or args.kernel
    if cfg.quant is not None and use_kernel:
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, use_kernel=True))
    out = {"cfg": cfg, "params": params, "quantize_s": quantize_s,
           "route": "fixed_slots", "registry": None, "tenants": []}
    if cfg.family in ("dense", "moe") and cfg.scan_layers:
        registry, tenants = build_registry(args, params)
        if registry is not None:
            engine = ServeEngine(params, cfg, registry,
                                 page_size=args.page_size,
                                 max_len=args.cache_len,
                                 bucket_capacity=args.batch,
                                 use_kernel=use_kernel,
                                 compile_cache=args.compile_cache or None)
            out.update(route="engine", registry=registry, tenants=tenants,
                       engine=engine)
            out["serve"] = serve_engine(engine, tenants,
                                        requests=args.requests,
                                        max_new=args.max_new,
                                        seed=args.seed)
            return out
    out["serve"] = serve_fixed_slots(
        params, cfg, batch=args.batch, cache_len=args.cache_len,
        requests=args.requests, max_new=args.max_new, seed=args.seed,
        device=device)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    metrics_out = args.metrics_out or (
        obs.default_metrics_path("serve") if args.trace_out else "")
    before = ops.launch_counts()
    with obs.session(args.trace_out or None, metrics_out or None):
        res = run(args)
    s = res["serve"]
    if args.tokens_out:
        with open(args.tokens_out, "w") as f:
            json.dump({"route": res["route"],
                       "outputs": [list(map(int, o)) for o in s["outputs"]]},
                      f)
    if res["route"] == "engine":
        print(f"[serve] requests={s['requests_done']}/{args.requests} "
              f"steps={s['steps']} tokens={s['tokens']} "
              f"quantize_s={res['quantize_s']:.4g} s={s['seconds']:.4g} "
              f"tok_s={s['tok_s']:.4g} tenants={s['tenants']} "
              f"rank_buckets={','.join(map(str, s['rank_buckets']))} "
              f"p50_ms={s['p50_ms']:.4g}")
        ok = s["requests_done"] == args.requests
    else:
        print(f"[serve] requests={s['requests_done']}/{args.requests} "
              f"steps={s['steps']} slot_tokens={s['slot_tokens']} "
              f"quantize_s={res['quantize_s']:.4g} s={s['seconds']:.4g} "
              f"tok_s={s['tok_s']:.4g}")
        ok = s["all_finite"]
    if args.compile_cache:
        cache = build.active_cache()
        launched = ",".join(f"{k}:{n - before[k]}"
                            for k, n in ops.launch_counts().items()
                            if n > before[k])
        obs_log.info("serve", "decode", cache_hits=cache.hits,
                     cache_misses=cache.misses, cache_corrupt=cache.corrupt,
                     cache_unportable=cache.unportable,
                     libraries=",".join(build.loaded()) or "none",
                     launches=launched or "none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
