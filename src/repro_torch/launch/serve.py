"""Serving CLI: CLoQ-quantize a model, then decode greedily in fixed slots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --max-new 16 --batch 4 --cache-len 128

Twin of ``repro.launch.serve``: the same flags plus ``--device`` (CUDA
unless ``--device cpu``).  It quantizes as the JAX CLI does (calibration on
2 x 64 tokens; group 64 and rank 64 at full size, 16 and 8 with
``--smoke``) and serves through the fixed-slot refill loop.  On a CUDA
device the quantized linears and decode attention run through the
hand-written kernels (``QSpec.use_kernel``); on the CPU they do so only
with ``--kernel`` and then take the kernels' plain versions.

The multi-tenant engine that the JAX CLI uses for adapter-carrying dense
models (``--tenants``, ``--ranks``, ``--adapter``, ``--page-size``) and
the compile cache, cost model and tracing flags are not ported yet
(``ROADMAP.md``); giving them raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe, load_plan
from repro_torch.data import DataConfig, TokenStream
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.modules import QSpec
from repro_torch.models.parallel import LOCAL
from repro_torch.models.transformer import init_decode_cache, init_params
from repro_torch.utils import resolve_device

# flags of the JAX CLI whose subsystems are not ported: name -> default
_NOT_PORTED = {"tenants": 0, "ranks": "", "adapter": [], "page_size": 8,
               "compile_cache": "", "cost_cal": "", "trace_out": "",
               "metrics_out": ""}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--method", default="cloq")
    p.add_argument("--recipe", default="",
                   help="QuantRecipe JSON, or a bucket-manifest JSON "
                        "embedding one; overrides --method/--bits")
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--batch", type=int, default=4, help="slot count")
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--kernel", action="store_true",
                   help="route quantized linears and decode attention "
                        "through the kernel wrappers (always on for CUDA)")
    # JAX CLI flags of subsystems not ported yet (rejected unless default)
    p.add_argument("--tenants", type=int, default=0)
    p.add_argument("--ranks", default="")
    p.add_argument("--adapter", action="append", default=[])
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--compile-cache", default="")
    p.add_argument("--cost-cal", default="")
    p.add_argument("--trace-out", default="")
    p.add_argument("--metrics-out", default="")
    return p


def _check_ported(args) -> None:
    given = [f"--{k.replace('_', '-')}" for k, default in _NOT_PORTED.items()
             if getattr(args, k) != default]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: the multi-tenant serving engine, compile "
            "cache, cost model and tracing are not ported to repro_torch yet "
            "(see ROADMAP.md)")


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
                          seed=args.seed)
        calib = [TokenStream(dcfg).next_batch()]
        params, cfg, _ = quantize_model(params, cfg, calib, recipe=recipe)
    return cfg, params


def serve_fixed_slots(params, cfg, *, batch: int, cache_len: int,
                      requests: int, max_new: int, seed: int,
                      device: str | torch.device,
                      keep_logits: bool = False) -> dict:
    """Fixed-slot refill loop: ``batch`` slots, each serving one request
    of ``max_new`` greedy tokens from a random first token, refilled as
    requests finish.  The KV cache position advances every step and is
    never rewound, so the run needs ``ceil(requests / batch) * max_new <=
    cache_len`` (checked up front).  Returns counts, times, the per-step
    input and output tokens, whether every logit was finite, and
    (``keep_logits``) the per-step logits on the CPU."""
    B = batch
    device = torch.device(device)
    if -(-requests // B) * max_new > cache_len:
        raise ValueError(
            f"{requests} requests x {max_new} tokens in {B} slots take "
            f"{-(-requests // B) * max_new} steps, more than --cache-len "
            f"{cache_len}")
    cache = init_decode_cache(cfg, B, cache_len, device=device)
    step = make_decode_step(cfg, LOCAL)

    rng = np.random.default_rng(seed)
    queue = [int(rng.integers(1, cfg.vocab)) for _ in range(requests)]
    slots = [None] * B             # [request_id, tokens_left] or None
    current = np.zeros((B, 1), np.int32)
    done, req_id, steps = 0, 0, 0
    inputs, outputs, logits_kept = [], [], []
    finite = torch.ones((), dtype=torch.bool, device=device)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        while done < requests:
            for s in range(B):          # refill free slots
                if slots[s] is None and queue:
                    slots[s] = [req_id, max_new]
                    current[s, 0] = queue.pop(0)
                    req_id += 1
            inputs.append(current[:, 0].copy())
            logits, cache = step(params, cache,
                                 torch.from_numpy(current).to(device))
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(dim=-1).cpu().numpy()
            outputs.append(nxt)
            if keep_logits:
                logits_kept.append(logits.float().cpu().numpy())
            steps += 1
            for s in range(B):
                if slots[s] is None:
                    continue
                slots[s][1] -= 1
                current[s, 0] = int(nxt[s]) % cfg.vocab
                if slots[s][1] <= 0:
                    done += 1
                    slots[s] = None
            if steps > requests * max_new + 16:
                break
    _sync(device)
    dt = time.perf_counter() - t0
    return {"requests_done": done, "steps": steps, "slot_tokens": steps * B,
            "seconds": dt, "tok_s": steps * B / dt,
            "all_finite": bool(finite), "inputs": inputs,
            "outputs": outputs, "logits": logits_kept}


def run(args, cfg=None) -> dict:
    """Build, quantize and serve as the CLI does.  ``cfg`` overrides the
    config chosen from ``--arch``/``--smoke`` (e.g. a depth-cut one).
    Returns the quantized ``params``/``cfg``, ``quantize_s`` and the
    ``serve`` summary of :func:`serve_fixed_slots`."""
    _check_ported(args)
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
    if cfg.quant is not None and (device.type == "cuda" or args.kernel):
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, use_kernel=True))
    summary = serve_fixed_slots(
        params, cfg, batch=args.batch, cache_len=args.cache_len,
        requests=args.requests, max_new=args.max_new, seed=args.seed,
        device=device)
    return {"cfg": cfg, "params": params, "quantize_s": quantize_s,
            "serve": summary}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    res = run(args)
    s = res["serve"]
    print(f"[serve] requests={s['requests_done']}/{args.requests} "
          f"steps={s['steps']} slot_tokens={s['slot_tokens']} "
          f"quantize_s={res['quantize_s']:.4g} s={s['seconds']:.4g} "
          f"tok_s={s['tok_s']:.4g}")
    return 0 if s["all_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
