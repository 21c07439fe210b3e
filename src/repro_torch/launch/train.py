"""Fine-tuning CLI: quantize a model, then train its LoRA adapters.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --bits 4 --group-size 64 --rank 64 --steps 100

``--arch``: the dense ``qwen3-1.7b``, ``qwen3-4b``, ``codeqwen1.5-7b`` and
``minicpm-2b``, the MoE ``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b``, the SSM
``mamba2-370m``, the hybrid ``zamba2-7b``, the enc-dec
``seamless-m4t-medium`` or the vision-prefix ``pixtral-12b``
(``repro_torch.configs``).  A hybrid model's shared block is quantized
once against its sites' pooled Gram and each site's LoRA pair is its own
CLoQ solve; the per-site pairs train like any other adapter.  An enc-dec
model's batches carry ``enc_embeds`` of ``max(seq_len // 4, 8)`` frames
and its cross-attention linears are sites like the others; a vision
model's carry ``n_prefix`` patch embeddings before the text.

Twin of ``repro.launch.train``: the same flags plus ``--device`` (CUDA
unless ``--device cpu``).  It builds the model from ``--seed``, optionally
pre-trains it in full precision (``--pretrain-steps``), calibrates on
``--calib-batches`` batches of the training stream, quantizes every block
linear and expert stack (``QuantRecipe.single`` from ``--method/--bits/
--group-size/--rank/--split``, or ``--recipe``; any of the five methods
cloq, gptq, loftq,
qlora and rtn, through the batched engine with the health guards on, whose
summary it prints), and trains the LoRA adapters only (everything, with
``--method none``) for ``--steps`` steps.  On a CUDA device calibration
runs through the ``gram`` kernel and the forward of every INT-quantized
linear through the fused ``dequant_matmul_lora`` kernel
(``QSpec.use_kernel``; a training batch has more rows than
``kernels.ops.FUSED_LORA_MIN_ROWS``); NF4 (``qlora``) sites and MoE expert
stacks dequantize in plain PyTorch, as the JAX package's do outside any
Pallas kernel.

Each step's time is taken on the host clock around a step that ends in a
device synchronize.  With ``--ckpt-dir`` the train state and the data
stream's position are saved every ``--ckpt-every`` steps and at the end
(``repro_torch.checkpoint``, the JAX package's format), and on SIGTERM or
SIGINT after the step in flight, pinned; ``--resume`` continues from the
newest step there.  With ``--resume-quant DIR`` every finished bucket of
the quantization is journaled in DIR (and the health report saved as
DIR/health.json); SIGTERM or SIGINT during quantization stops it at the
next bucket boundary with exit code 0, and a rerun with the same DIR
restores the committed buckets bit-identical.

With ``--auto-allocate --budget-mb B`` the recipe is derived instead:
the model is calibrated, every site swept over ``--bits`` in {2, 3, 4} x
``--rank`` in {0, 16, 64} of ``--method`` through the batched engine, and
the budget solver picks each site group's candidate under ``B`` MiB of
quantized sites (``repro_torch.core.allocate``; the plan's summary is
printed); quantization then calibrates again on the same batches, as the
JAX CLI does.  Every checkpoint of a quantized run carries the bucket
manifest of its recipe (``pipeline.quantization_manifest``) in
``meta.json``.

``--trace-out FILE`` writes a chrome-trace span timeline of the run
(``quant.*``, ``bucket.*``, ``health.*``, ``train.step``, ``ckpt.*``;
load it at https://ui.perfetto.dev; ``REPRO_TRACE_SYNC=1`` fences the
CUDA work a span launched before it closes) and ``--metrics-out FILE``
the metrics snapshot (``results/metrics-train.json`` when only
``--trace-out`` is given), as the JAX CLI does (``repro_torch.obs``).
Progress lines go through ``obs.log``.  ``--cost-cal FILE|auto`` plans the
quantization buckets with the cost model (``repro_torch.core.costmodel``;
``auto`` measures this host once and caches the table).  ``--compile-cache
DIR`` is the directory the CUDA kernel libraries are built into and loaded
from (``repro_torch.core.compile_cache``; default ``build/repro_torch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import signal
import statistics
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.health import HealthReport, QuantPreempted
from repro_torch.core.allocate import default_grid
from repro_torch.core.pipeline import (allocate_plan, quantization_manifest,
                                       quantize_model)
from repro_torch.core.recipe import QuantRecipe, load_plan
from repro_torch.data import DataConfig, TokenStream, data_kind
from repro_torch.kernels import build
from repro_torch.launch.steps import build_state, make_train_step
from repro_torch.models.modules import QSpec
from repro_torch.models.parallel import LOCAL
from repro_torch.models.transformer import init_params
from repro_torch import obs
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import OptConfig, merge_params
from repro_torch.utils import resolve_device

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-runnable)")
    p.add_argument("--method", default="cloq",
                   choices=["cloq", "gptq", "loftq", "qlora", "rtn", "none"])
    p.add_argument("--recipe", default="",
                   help="QuantRecipe JSON, or a bucket-manifest JSON "
                        "embedding one; overrides --method/--bits/"
                        "--group-size/--rank/--split")
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--group-size", type=int, default=64)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--split", default="paper")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", default="cosine",
                   choices=["const", "linear", "cosine", "wsd"])
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--pretrain-steps", type=int, default=0,
                   help="optional full-precision warm start (smoke demos)")
    p.add_argument("--straggler-factor", type=float, default=3.0)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--resume-quant", default="", metavar="DIR",
                   help="journal the quantization's buckets in DIR and "
                        "resume from the ones committed there")
    p.add_argument("--auto-allocate", action="store_true",
                   help="derive the recipe: sensitivity sweep + budget "
                        "solver under --budget-mb")
    p.add_argument("--budget-mb", type=float, default=0.0,
                   help="byte budget (MiB) of the quantized sites for "
                        "--auto-allocate")
    p.add_argument("--trace-out", default="", metavar="FILE",
                   help="write a chrome-trace/Perfetto span timeline of "
                        "the run to FILE (load at https://ui.perfetto.dev; "
                        "REPRO_TRACE_SYNC=1 fences the CUDA work at span "
                        "close)")
    p.add_argument("--metrics-out", default="", metavar="FILE",
                   help="write the metrics-registry snapshot to FILE "
                        "(defaults to results/metrics-train.json when "
                        "--trace-out is set)")
    p.add_argument("--cost-cal", default="", metavar="FILE|auto",
                   help="cost-model calibration driving the bucket "
                        "planner's sharded/replicated/sequential choice: a "
                        "calibration JSON, or 'auto' to measure this host "
                        "once and cache the result "
                        "(repro_torch.core.costmodel.calibrate)")
    p.add_argument("--compile-cache", default="", metavar="DIR",
                   help="directory the CUDA kernel libraries are built "
                        "into and loaded from (default build/repro_torch; "
                        "repro_torch.core.compile_cache)")
    return p


def _check_allocation_flags(args) -> None:
    """The JAX CLI's checks of ``--auto-allocate``/``--budget-mb``."""
    if args.auto_allocate and args.recipe:
        raise SystemExit("--auto-allocate derives the recipe; it conflicts "
                         "with an explicit --recipe")
    if args.auto_allocate and args.method == "none":
        raise SystemExit("--auto-allocate conflicts with --method none")
    if args.budget_mb and not args.auto_allocate:
        raise SystemExit("--budget-mb only applies with --auto-allocate")
    if args.auto_allocate and args.budget_mb <= 0:
        raise SystemExit("--auto-allocate needs --budget-mb > 0")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, cfg=None) -> dict:
    """Build, quantize and fine-tune as the CLI does.  ``cfg`` overrides the
    config chosen from ``--arch``/``--smoke`` (e.g. a depth-cut one).
    Returns the final ``state`` and ``cfg``, ``quantize_s``, with
    ``--auto-allocate`` the ``allocation`` and ``allocate_s`` (else None
    and 0), the quantization's ``health`` report (None with ``--method none``), the
    first step run (``start_step``: > 0 after a resume), per step run
    ``losses``, ``grad_norms`` and ``step_s``, the newest saved step
    (``ckpt_step``, None without ``--ckpt-dir``) and whether a signal
    stopped the run (``preempted``; ``state`` is None when it stopped the
    quantization).

    SIGTERM and SIGINT, from before quantization on, set a flag that ends
    the run after the step in flight, with a pinned save when
    checkpointing, or with ``--resume-quant`` at the quantization's next
    bucket boundary; the previous handlers are restored on return."""
    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    prev = {sig: signal.signal(sig, on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _run(args, cfg, stop)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def _run(args, cfg, stop: dict) -> dict:
    _check_allocation_flags(args)
    if args.compile_cache:
        build.use_cache(args.compile_cache)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    group_size = args.group_size
    if args.smoke and group_size > cfg.d_model:
        group_size = min(group_size, 16)
    params = init_params(cfg, seed=args.seed, device=device)
    stream = TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        seed=args.seed, kind=data_kind(cfg),
        enc_len=max(args.seq_len // 4, 8), n_prefix=cfg.n_prefix,
        d_model=cfg.d_model))

    if args.pretrain_steps:
        ocfg0 = OptConfig(lr=3e-3, trainable="all",
                          total_steps=args.pretrain_steps, schedule="cosine")
        st0 = build_state(params, ocfg0)
        step0 = make_train_step(cfg, ocfg0, LOCAL)
        for _ in range(args.pretrain_steps):
            st0, m0 = step0(st0, stream.next_batch())
        params = merge_params(st0["train"], st0["frozen"])
        obs_log.info("pretrain", steps=args.pretrain_steps,
                     loss=float(m0["loss"]))

    recipe = None
    if args.recipe:
        recipe = load_plan(args.recipe)
    elif args.method != "none" and not args.auto_allocate:
        recipe = QuantRecipe.single(
            args.method, QSpec(bits=args.bits, group_size=group_size,
                               rank=args.rank, method=args.method,
                               split=args.split))
    calib, alloc, allocate_s = None, None, 0.0
    if args.auto_allocate:
        base = QSpec(bits=args.bits, group_size=group_size, rank=args.rank,
                     method=args.method, split=args.split)
        calib = [stream.next_batch() for _ in range(args.calib_batches)]
        _sync(device)
        t0 = time.perf_counter()
        # the candidate bits x ranks of the CLI's method
        alloc = allocate_plan(params, cfg, calib,
                              int(args.budget_mb * 2**20),
                              grid=default_grid(methods=(args.method,)),
                              qspec=base)
        _sync(device)
        allocate_s = time.perf_counter() - t0
        obs_log.info("allocate", s=allocate_s)
        print(alloc.summary(), flush=True)
        recipe = alloc.recipe
    quantize_s = 0.0
    report = manifest = None
    if recipe is not None:
        if calib is None:
            calib = [stream.next_batch() for _ in range(args.calib_batches)]
        cost_model = None
        if args.cost_cal:
            from repro_torch.core.costmodel import CostModel, calibrate
            cal = (calibrate(device=device) if args.cost_cal == "auto"
                   else args.cost_cal)
            cost_model = CostModel.coerce(cal)
        journal_dir = args.resume_quant or None
        report = HealthReport()
        _sync(device)
        t0 = time.perf_counter()
        try:
            params, cfg, _ = quantize_model(
                params, cfg, calib, recipe=recipe,
                report=report, journal_dir=journal_dir,
                cost_model=cost_model,
                should_stop=(lambda: stop["flag"]) if journal_dir else None)
        except QuantPreempted as e:
            obs_log.warn("preempt-quant",
                         f"signal received — buckets 0..{e.bucket} "
                         f"committed to {journal_dir}; rerun with the same "
                         "--resume-quant to continue")
            return {"cfg": cfg, "state": None, "quantize_s": 0.0,
                    "allocation": alloc, "allocate_s": allocate_s,
                    "health": report, "start_step": 0, "losses": [],
                    "grad_norms": [], "step_s": [], "preempted": True,
                    "ckpt_step": None}
        _sync(device)
        quantize_s = time.perf_counter() - t0
        obs_log.info("quantize", rules=len(recipe.rules),
                     default=f"{recipe.method}/{recipe.qspec.bits}b",
                     s=quantize_s)
        obs_log.info("quantize", report.summary())
        # checkpoints carry the plan they were quantized with
        manifest = quantization_manifest(cfg, recipe=recipe)
        if device.type == "cuda":
            cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
                cfg.quant, use_kernel=True))
        trainable = "lora"
    else:
        trainable = "all"

    ocfg = OptConfig(lr=args.lr, trainable=trainable, total_steps=args.steps,
                     schedule=args.schedule)
    state = build_state(params, ocfg)
    del params
    step_fn = make_train_step(cfg, ocfg, LOCAL)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3, every=args.ckpt_every)
        if args.resume and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(device=device)
            stream.load_state_dict(meta["data"])
            start_step = meta["step"]
            obs_log.info("resume", step=start_step)

    def save(step: int, **kw) -> None:
        ckpt.maybe_save(step, state, {"data": stream.state_dict(),
                                      "step": step}, manifest=manifest, **kw)

    step_hist = obs_metrics.histogram(obs_names.TRAIN_STEP_TIME)
    step_count = obs_metrics.counter(obs_names.TRAIN_STEPS)
    losses, gnorms, times = [], [], []
    preempted = False
    for step in range(start_step, args.steps):
        batch = stream.next_batch()
        _sync(device)
        t0 = time.perf_counter()
        with obs_trace.span("train.step", step=step):
            state, metrics = step_fn(state, batch)
            # the step time below measures the device work, not the enqueue
            _sync(device)
        dt = time.perf_counter() - t0
        step_hist.observe(dt)
        step_count.inc()
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if len(times) >= 5:
            med = statistics.median(times[-50:])
            if dt > args.straggler_factor * med:
                obs_log.warn("straggler", step=step, s=dt, median_s=med)
        times.append(dt)
        if step % 10 == 0 or step == args.steps - 1:
            obs_log.info("step", i=step, loss=losses[-1],
                         lr=float(metrics["lr"]), gnorm=gnorms[-1],
                         ms=dt * 1e3)
        if ckpt is not None:
            save(step + 1)
        if stop["flag"]:
            obs_log.warn("preempt", step=step + 1)
            preempted = True
            if ckpt is not None:
                # pinned: retention never collects the preemption save
                save(step + 1, force=True, pin=True)
            break
    else:
        if ckpt is not None:
            save(args.steps, force=True)
    if ckpt is not None:
        ckpt.wait()
    return {"cfg": cfg, "state": state, "quantize_s": quantize_s,
            "allocation": alloc, "allocate_s": allocate_s,
            "health": report, "start_step": start_step, "losses": losses, "grad_norms": gnorms,
            "step_s": times, "preempted": preempted,
            "ckpt_step": None if ckpt is None else ckpt.latest_step()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    metrics_out = args.metrics_out or (
        obs.default_metrics_path("train") if args.trace_out else "")
    with obs.session(args.trace_out or None, metrics_out or None):
        res = run(args)
    if res["preempted"]:
        return 0
    final = res["losses"][-1] if res["losses"] else float("nan")
    print("[done] " + json.dumps({"final_loss": final}), flush=True)
    return 0 if all(map(math.isfinite, res["losses"])) else 1


if __name__ == "__main__":
    sys.exit(main())
