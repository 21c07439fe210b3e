#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--layers L] [--moe-layers L] [--hybrid-layers L]
                          [--vlm-layers L]
                          [--only analysis|compile_cache|kernels|lora|configs|
                                  ssm|encdec|allocate|levers|trace|distributed|
                                  train_sharded]
                          [--families A,B] [--family-dtype float32]
                          [--seq-kv-only]

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — the four CUDA kernels compiled from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (into the git-ignored compile cache
   ``build/repro_torch``), with seconds and the ``ptxas`` register and
   spill report (and any warning that names ``wgmma``: a serialized
   pipeline).
   analysis — the port's static gate (``repro_torch.analysis``): the lint
   of ``src/repro_torch`` (gating: must be 0) and ``chip_*.py`` (report),
   the 30-cell shape fleet against the JAX package's goldens (0 diffs),
   then two rules held against the card: a ``CapturedStep`` whose step
   calls ``.item()`` must raise at its capture where PURITY flags it and
   hand back the caller's stream and the allocator
   (``allocator_recovered``: 80% of the free memory allocates after
   it), its clean twin capture, replay and pass; a captured
   Qwen3-1.7B-smoke decode
   replay timed by the host clock without a sync must be shorter than
   with one, BENCH flagging the first source and passing the second.
   compile_cache — two fresh serve processes (``CACHE_SERVE``) on the
   build's cache directory, ``nvcc`` behind a shim that logs each call:
   the warm one hits every library it loads, compiles nothing and counts
   a capture a rank bucket as ``unportable``; the second, on a copy with
   ``dequant_matmul``'s library cut to half its bytes, counts it corrupt,
   warns, rebuilds it with one ``nvcc`` and gives the same tokens.
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes (Qwen3-1.7B's and every other ported
   config's, MoE expert slices and the SSM families' narrow outputs
   included) and at a sweep of others, with
   ``torch.cuda.synchronize()`` after each launch, on every route its plan
   function picks, each case's route and error on a ``dequant_cases``,
   ``flash_cases``, ``gram_cases`` or ``lora_cases`` line; the decode and
   train shapes run twice for equal bits, and ``gram``'s tensor-core
   cases must also meet the f32 tolerance (exact products).
   ``flash_attention``'s partial mode (``return_lse``, the
   sequence-sharded decode's softmax over a rank's keys) on both decode
   routes, zero-length rows and a ragged shard included, on a
   ``flash_partial_cases`` line (:data:`FLASH_PARTIAL`), and timed at
   decode_32k's production shard (``flash_attention_partial``, with the
   bulk route's splits and rings beside the plan's: ``by_plan``; the
   decode step's times carry ``by_splits``).  Then the kernel, the plain
   version and one PyTorch library call timed over one step's worth of
   calls (CUDA graphs
   replayed between CUDA events), the least time the card could take for
   the same work and, for the decode kernels, the bytes/s reached and
   their share of 3.35 TB/s.  ``dequant_matmul`` and ``flash_attention``
   are timed over one decode step (``flash_attention`` also over a
   4096-key cache, where it moves bytes rather than waits), ``gram`` over
   one calibration batch of the fine-tuning run and
   ``dequant_matmul_lora`` over one training forward.  dequant_splits: the
   tensor-core route of ``dequant_matmul`` at 1 to 8 blocks a cluster for
   each Qwen3-1.7B linear, the data behind ``dqmm_plan``'s split.
   gram_tiles: ``gram``'s tensor-core route at each calibration width with
   1/4 to all of the SMs' worth of persistent blocks, the data behind
   ``gram_plan``'s grid.  Then lora_route:
   the two routes ``linear_apply`` can take for a quantized linear with
   LoRA on the kernel path (fused kernel; ``dequant_matmul`` plus unfused
   LoRA) timed at 4 to 1024 rows, which sets ``ops.FUSED_LORA_MIN_ROWS``.
   lora_precision: the fused kernel's wgmma route at K = 14336 (Pixtral's
   and Zamba2's down projections) against the exact product (held: within
   2^-8 |exact| + 1e-3, one bf16 rounding of its output and its f32 sums)
   and the plain version (held: no element outside the JAX bf16
   tolerance), at the sweep's weight std (0.02) and at the model's
   (K^-0.5); the enc-dec and vision paths' cases run at both.
4. parity  — the smoke model quantized on the card and decoded with the
   kernels and with the plain path: logits agree and tokens are equal.
5. train_parity — the smoke model quantized on the card takes 3 LoRA steps
   twice from the same params and batches, through the kernels (``gram``
   in calibration, fused ``dequant_matmul_lora``) and plain: per-step
   losses agree; and the fused op's backward (dx, dA, dB) agrees with
   autograd through the plain version at a training shape.
6. engines — the quantization engines on qwen3-1.7b at full width,
   ``ENGINE_LAYERS`` (1) deep, f32, CLoQ 4-bit, group 64, rank 64:
   ``engine="sequential"`` then ``"batched"`` (4 buckets), every site
   compared in the terms of the reference's batched-vs-sequential oracle
   beside the sequential engine against itself with every Gram entry one
   ulp off; held: scales, zeros and the calibrated objective
   ``gram_error`` within 1e-3 relative, code flips within 0.005 or twice
   the one-ulp run's on the site (``A @ B^T`` reported: one ulp moves it
   ~50% at this width); seconds and peak memory per engine; then the
   batched engine once more with every bucket cut into one-slice chunks
   (``chunked``), held to the same limits.  quantize_split: the CLoQ
   stack of half a full-depth bucket (gate+up, 28 of 56 x 2048 x 6144;
   down, 14 of 28 x 6144 x 2048; random
   weights and Grams) split into MagR, the OPTQ sweep and ``eigh``/``svd``
   with CUDA events, and ``slice_factor``: the batched engine's peak
   memory a slice over its f32 W and H bytes at five slice shapes (at
   most ``batched.SLICE_WORK_FACTOR``, which sizes a bucket's chunks).
   health: the batched engine with ``gram_nan``
   injected at ``blocks.0.attn.q``: all leaves finite, that site healed
   by the identity Gram, every other leaf bit-identical to the clean
   batched run.  journal: a journaled batched run stopped after bucket 0
   raises ``QuantPreempted``; the rerun restores bucket 0 and its leaves
   are bit-identical to the uninterrupted run.  methods:
   ``repro_torch.launch.train`` with gptq, loftq, qlora and rtn at full
   width, ``ENGINE_LAYERS`` deep, 2 steps (calibration 2 x 8 x 128):
   finite losses,
   ``gram`` 7 a layer a calibration batch, ``dequant_matmul_lora`` 7 a
   layer a step (0 for NF4 ``qlora``), ``B == 0`` at init but for loftq.
7. train   — ``repro_torch.launch.train`` on qwen3-1.7b at full width and
   all 28 layers (CLoQ 4-bit, group 64, rank 64, calibration 4 x 8 x 128
   tokens, batch 8, sequence 128, 4 LoRA steps; the batched engine, the
   CLI's default), saving its state with ``--ckpt-dir`` under the
   git-ignored ``build/chip_smoke/``.  The launch counters are reset just
   before and read just after; ``gram`` and ``dequant_matmul_lora`` must
   match the calibration and step counts, step 4 must be saved, the
   losses must be within 1e-2 relative of ``REF_LOSSES`` and the health
   guards must report no fallback.  Quantize seconds, step seconds,
   tokens/s, peak memory, the losses and the saved step.  Then
   train_profile: two more steps under ``torch.profiler`` (step time,
   device busy and idle share, top kernels).
8. serve   — ``repro_torch.launch.serve`` on qwen3-1.7b at full width with
   the CLI's full-size settings (CLoQ 4-bit, group 64, rank 64, 2 x 64
   calibration tokens, cache 128), through its route for such a model,
   the multi-tenant engine: ``--tenants 4 --ranks 64,16 --batch 4
   --page-size 8``, 8 requests x 16 tokens, and ``--adapter tuned=`` the
   train phase's checkpoint; ``--layers`` deep (all 28 by default; a cut
   depth serves no ``tuned``, whose adapters have 28 layers).  Each rank
   bucket's decode step is captured as a CUDA graph.  Counters reset
   just before and read just after: ``dequant_matmul`` and
   ``flash_attention`` must count 7 and 1 a layer for every bucket decode
   (replays counted as their captured launches), ``gram`` > 0; the
   ``serve.*`` counters must show 8 requests finished with 16 tokens
   each; both rank buckets must decode and ``tuned`` must be served.
9. serve_graph — on the served params, the engine with its steps eager
   and captured, and the fixed-slot loop (batch 4, 8 requests x 16
   tokens) eager and captured: equal greedy tokens for each pair, the
   fixed-slot loop counting 6272 ``dequant_matmul`` and 896
   ``flash_attention`` launches both ways; slot tokens/s of each run.
10. profile — the fixed-slot loop and the engine (4 requests x 16 tokens
   each, ``PROFILE_REQUESTS``), each eager and
   captured (after a warm run of each), under ``torch.profiler``
   recording the device's events only: step
   time (also the median of the steps' own host times), device busy time
   a step and idle share, top kernels.
11. moe — OLMoE-1B-7B at full width (d_model 2048, 64 experts top-8,
   expert d_ff 1024, vocab 50304, bf16), ``--moe-layers`` deep (2 by
   default, cut from 16): the train CLI's path (CLoQ 4-bit g64 r64,
   calibration 2 x 8 x 128, 3 steps at 8 x 128), the same steps on the
   plain path from the same quantized params and batches, then the
   engine route on the quantized params (ranks 64 and 16, 4 tenants, 8
   one-token requests x 16 tokens) eager and captured.  Quantize seconds,
   each bucket's slices and chunks, peak memory, losses and their largest
   relative difference from the plain path's (held to 1e-2), step seconds
   and tokens/s, engine slot tokens/s, launches, the share of routed token
   slots dropped at capacity; held: an empty health report, captured
   tokens equal to eager ones, every kernel's launches.
12. configs — Qwen3-4B, CodeQwen1.5-7B, MiniCPM-2B (CLoQ 4-bit g64 r64)
   and Qwen3-30B-A3B (RTN: its experts' Grams are not read) at full
   width, 1 layer each: the train CLI's path (2 steps), then the engine
   (4 requests x 8 tokens) eager and captured.  Quantize seconds, peak
   memory, the routes each kernel took, the largest difference of kernel
   against plain decode logits; held: captured tokens equal to eager
   ones, finite losses, an empty health report, the launches, the logits
   difference within ``logits_limit`` (the JAX package's bf16 kernel
   tolerance, grown by the square root of the kernel calls a decode step
   makes, on the logits' own scale).
13. ssm — Mamba2-370M (12 of its 48 layers, d_model 1024, state 128)
   and Zamba2-7B (d_model 3584, the shared attention + MLP block with
   d_ff 14336 after every 6 Mamba layers), ``--hybrid-layers`` deep (12
   by default, cut from 81: two shared-block sites), at full width, bf16:
   the train CLI's path (CLoQ 4-bit g64 r64, calibration 2 x 8 x 128, 3
   steps at 8 x 128), the same steps on the plain path from the same quantized params
   and batches, then the serve CLI's route for these families, the
   fixed-slot loop (batch 4, 8 requests x 16 tokens, cache 128), eager and
   captured.  Quantize seconds, buckets and chunks, memory and host
   seconds at each bucket's end, peak memory, losses, step seconds and
   tokens/s, slot tokens/s eager and captured, the routes each kernel
   took, the largest difference of kernel against plain decode logits,
   the launches; for Zamba2, each shared linear's per-site objective
   matrix (site s's regularized Gram against each site's ``A @ B^T``).
   Held: losses finite and within 1e-2 of the plain path's, an empty
   health report, captured tokens equal to eager ones, ``gram`` (5 a
   Mamba layer + 7 a site) x calibration batches, ``dequant_matmul_lora``
   the same a step, ``dequant_matmul`` the same a decode step,
   ``flash_attention`` none (the shared block's windowed ring decodes in
   plain PyTorch, as in the JAX package), and each site's adapter at
   least as good on its own Gram as the other's (x (1 + 1e-4)), the two
   sites' ``A @ B^T`` more than 1e-2 apart, kernel against plain decode
   logits within ``logits_limit``.
14. encdec — Seamless-M4T-medium at full width, 2 encoder and 2 decoder
   layers (``SEAMLESS_LAYERS``, cut from 12 + 12; d_model 1024, vocab
   256206, bf16) and
   Pixtral-12B at full width (d_model 5120, GQA 32/8, d_ff 14336, vocab
   131072), ``--vlm-layers`` deep (1 by default, cut from 40): the train
   CLI's path (CLoQ 4-bit g64 r64, calibration 2 x 8 x 128 with 32
   encoder frames or 256 patches a sequence, 3 steps at 8 x 128), the
   same steps on the plain path from the same quantized params and
   batches, then the serve CLI's route: seamless's fixed-slot loop (batch
   4, 8 requests x 16 tokens, cache 128) against an encoder output of the
   port's encoder over seeded frames, Pixtral's engine (ranks 64/16, 4
   tenants, 4 requests x 8 tokens), eager and captured.  Quantize
   seconds, buckets and chunks, peak memory, losses, step seconds and
   tokens/s, slot tokens/s, routes (every stack's, a cross k/v's fused
   decode route third), launches; for seamless, one captured decode
   step's device ms beside its cross k/v projections' alone (the fused
   kernel over all of ``enc_out``'s rows, 2 a layer).  Held: losses
   finite and within 1e-2 of the plain path's, an empty health report,
   captured tokens equal to eager ones, kernel against plain decode
   logits within ``logits_limit`` (seamless's from a real encoder
   output), ``gram`` and ``dequant_matmul_lora`` 7 a dense block and 4 a
   cross block a calibration batch and a step (36 for seamless), a
   decode step's ``dequant_matmul`` 9 a seamless decoder layer (7 a
   Pixtral layer), ``dequant_matmul_lora`` 2 a seamless layer (its cross
   k/v over all of enc_out), ``flash_attention`` 1 a layer.
15. allocate — Qwen3-1.7B at full width, ``ALLOC_LAYERS`` (1) deep, the
   only mixed-bit model: the train CLI's ``--auto-allocate`` path (CLoQ,
   base 4-bit g64 r64, the sweep over 2/3/4 bits x ranks 0/16/64,
   calibration 2 x 8 x 128 twice, 2 steps at 8 x 128) under a
   ``--budget-mb`` midway between all (2 bits, rank 0) and all (4 bits,
   rank 64), then the fixed-slot decode of the trained model (batch 4, 4
   requests x 8 tokens) eager and captured.  Each group's chosen (bits,
   rank), the sweep and quantize seconds, peak memory, losses, routes;
   held: the plan within budget, ``recipe_plan_bytes`` = the plan's bytes
   = the returned sites' bytes, each group's sweep error within 1e-3 of
   ``tr(E^T H E)`` from the engine's leaves, finite losses, an empty
   health report, the launches, captured tokens equal to eager ones,
   kernel against plain logits within ``logits_limit``, and the
   checkpoint's ``meta.json`` carrying the manifest with the
   ``plan_fingerprint`` of ``(cfg, recipe)``.
16. levers — Qwen3-1.7B at full width and all 28 layers, RTN 4-bit g64
   r64 (no Gram), 2 steps at batch 8 x 1024 under ``remat`` none, full,
   tp_out and dots, then full with ``attn_chunk`` and ``loss_chunk`` 256,
   each from the same params and batches: peak GB, step seconds,
   tokens/s, fused launches a step and losses.  Held: every recompute
   policy's losses within 1e-5 of "none"'s, the chunked run's within
   1e-3, "full"'s peak below "none"'s, the launches ``fused_a_step``
   says (batch 4 for all when "none" does not fit).
17. trace — Qwen3-1.7B at full width, 1 layer, CLoQ: the train CLI's
   path with ``--trace-out``/``--metrics-out`` under
   ``REPRO_TRACE_SYNC=1`` (2 steps), again untraced, and the serve CLI's
   engine (2 tenants, captured decode) traced, then untraced on the same
   engine; files under ``build/chip_smoke/``.  Each span's count and
   total ms, the share of ``quant.model`` the synced ``bucket.execute``
   spans cover, the step time traced and untraced.  Held: the files
   parse; ``train.step`` x steps, ``bucket.execute`` x buckets,
   ``serve.decode`` x the engine's decodes; the same tokens traced and
   untraced.

Between journal and methods run ``distributed`` (the column-sharded
quantization engine on 2 gloo ranks) and ``train_sharded``: each of
:data:`SHARDED_FAMILIES` (Qwen3-1.7B, Mamba2, Zamba2, Seamless, Pixtral
at full width) restored by 4 gloo ranks sharing the card as a (data 2,
model 2) mesh, its steps with and without ``seq_shard`` and its decode
held against the unsharded ones (Qwen3-1.7B's ``ef_psum_int8`` too),
OLMoE's expert-parallel steps, and ``seq_kv``: Qwen3-30B-A3B decoded by
8 ranks as a (data 1, model 8) mesh whose cache ``cache_specs`` shards
along the sequence (the distributed softmax over the partial
``flash_attention``), its logits, launches and collectives a step held
(:func:`train_sharded_phase`).

Every training phase runs under the port's default ``remat="full"`` (the
JAX package's): each fused linear launches again in the backward's
recompute, so a step's ``dequant_matmul_lora`` launches are
``fused_a_step``'s (twice the forward's for the dense, MoE and SSM
families and the stacked enc-dec layout, three times for a hybrid
segment's blocks).

``--moe-layers`` at another depth than 2 (``--moe-layers 16``: the
full-depth check) runs the device and build phases and the moe phase
alone; ``--hybrid-layers`` at another depth than 12 (at least 12;
``--hybrid-layers 81``: the full-depth check) the device and build phases
and the ssm phase alone; ``--vlm-layers`` at another depth than 1
(``--vlm-layers 40``: the full-depth check) the device and build phases
and Pixtral-12B alone by RTN with no calibration batch (at 40 layers
CLoQ's Grams would not fit beside the weights); ``--only PHASE`` the
device and build phases and that phase alone.  Otherwise the kernel table follows as one JSON
line (each kernel's launches from the path that runs it: train for
``gram`` and ``dequant_matmul_lora``, the engine serve for the others;
from the moe phase's, ``launches_moe``; from the ssm phase's, both
models summed, ``launches_ssm``; from the encdec phase's, both models
summed, ``launches_encdec``; from the allocate phase's,
``launches_allocate``; from the levers phase's runs summed,
``launches_levers``; from the trace phase's, ``launches_trace``: the
serve run's for the decode kernels, the traced train run's for the
others; from the compile_cache phase's warm serve process,
``launches_compile_cache``; ``flash_attention``'s ``plan_route``: the
bf16 decode's route, ``cache_4096``: its times at a 4096-key cache, and
``partial``: the partial mode's route, split, time, bound, plain and
library times at the production shard and its launches in ``seq_kv``),
the ``nvidia-smi`` name and power limit line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without the ``ok`` line, as does a host without CUDA or a directory
without the repository's ``src/repro_torch``.

TF32 is switched off for matmuls and cuDNN, so f32 references are f32.
Bounds: bytes over 3.35 TB/s against operations over the peak rate of the
inputs' type on the H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
f32 outside them), the larger of the two.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM, dense bf16 tensor cores
# the JAX package's kernel tolerances (tests/test_kernels.py)
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}        # dequant
TOL_ATTN = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}   # flash
TOL_GRAM = {"float32": (1e-4, 1e-2), "bfloat16": (2e-2, 2e-1)}   # gram

# the serving path's quantized linears per layer: (K, N) of q, k, v, o,
# gate, up, down at qwen3-1.7b's widths
QWEN_LINEARS = ((2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
                (2048, 6144), (2048, 6144), (6144, 2048))


# the configs slices 8, 9 and 11 add, each at its published widths
NEW_CONFIGS = ("qwen3-4b", "codeqwen1.5-7b", "minicpm-2b", "olmoe-1b-7b",
               "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b",
               "seamless-m4t-medium", "pixtral-12b")


def config_shapes(c) -> dict:
    """The kernel shapes of one layer of the model config ``c`` (and of a
    hybrid's shared block): ``linears`` (K, N) of its quantized 2-D
    linears (attention's q, k, v, o, an enc-dec model's cross-attention's
    alike; dense and shared gate/up and down; Mamba's z/x, bc, dt and out
    projections), ``heads`` (Hq, Hkv, d) of
    the decode attention the flash kernel runs (None for SSM and hybrid:
    the hybrid's windowed ring decodes in plain PyTorch, as in the JAX
    package) and ``grams`` the calibration widths D (and, for MoE, the
    expert slices')."""
    linears, grams, heads = set(), set(), None
    if c.family in ("ssm", "hybrid"):
        s = c.ssm_cfg()
        linears |= {(c.d_model, s.d_inner), (c.d_model, s.d_bc),
                    (c.d_model, s.n_heads), (s.d_inner, c.d_model)}
        grams |= {c.d_model, s.d_inner}
    if c.family != "ssm":
        q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        linears |= {(c.d_model, q), (c.d_model, kv), (q, c.d_model)}
        grams |= {c.d_model, q}
        if c.family == "moe":
            grams.add(c.d_ff_expert)
        else:
            linears |= {(c.d_model, c.d_ff), (c.d_ff, c.d_model)}
            grams.add(c.d_ff)
        if c.family != "hybrid":
            heads = (c.n_heads, c.n_kv_heads, c.head_dim)
    return {"linears": sorted(linears), "heads": heads,
            "grams": sorted(grams)}


def new_shapes(key: str) -> list:
    """``config_shapes(...)[key]`` over NEW_CONFIGS at their published
    widths, each shape once."""
    from repro_torch.configs import get_config
    out = []
    for name in NEW_CONFIGS:
        v = config_shapes(get_config(name))[key]
        for x in (v if isinstance(v, list) else [v]):
            if x is not None and x not in out:
                out.append(x)
    return out


# where the train phase saves its state and the serve phase loads the
# ``tuned`` tenant from (git-ignored)
CKPT_DIR = ROOT / "build" / "chip_smoke" / "train_ckpt"

T0 = time.perf_counter()


class Failed(Exception):
    pass


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flops_per_s: float) -> dict:
    """The least time for the work: the larger of bytes over HBM rate and
    operations over ``flops_per_s``; the f32 CUDA-core figure beside."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "flops_rate": flops_per_s, "f32_cuda_core_ms": 1e3 * max(
                t_bytes, flops / F32_FLOPS)}


def within(a, b, tol) -> tuple[bool, float]:
    rtol, atol = tol
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all()) and \
        bool(a.isfinite().all())
    return ok, float(err.max())


def time_graph(torch, fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn`` (a sequence of launches), captured
    once in a CUDA graph and replayed between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# dequant_matmul
# ---------------------------------------------------------------------------


def _quantized(torch, K, N, bits, g, dev, gen, any_zero: bool = False,
               w_std: float = 0.02):
    from repro_torch.core.quantizer import pack_codes, quantize_int
    W = torch.randn((K, N), generator=gen, device=dev) * w_std
    codes, s, z = quantize_int(W, bits, g)
    if any_zero:    # shift each zero by U(-0.5, 0.5), some by -2^bits
        z = z + torch.rand(z.shape, generator=gen, device=dev) - 0.5
        z = z - (1 << bits) * (torch.rand(z.shape, generator=gen,
                                          device=dev) < 0.25)
    return pack_codes(codes, bits), s, z


# check_dequant's decode cases (bf16, the tensor-core route): 1 to 8 rows at
# every Qwen3-1.7B linear, run twice for equal bits; then K not a multiple
# of the 256-row stage, groups 32, 128 and 256, every width
DEQUANT_DECODE_ROWS = (1, 3, 4, 8)
DEQUANT_ODD = ((4, 2112, 256, 64), (3, 192, 384, 32), (8, 2048, 1024, 32),
               (4, 2048, 1024, 128), (1, 6144, 128, 128), (5, 1024, 512, 256))
# zeros that are not whole numbers, or lie outside the codes' range (a
# checkpoint from another quantizer): both routes take any f32 zero
DEQUANT_ANY_ZERO = ((4, 2048, 1024, 64), (9, 384, 256, 32))


def check_dequant(torch, dev) -> tuple[dict, list]:
    """The kernel against its plain version: the decode cases (Qwen3-1.7B's
    linears at 1 to 8 rows, the other configs' at 1 and 4; each run
    twice: the same bits both times), the odd shapes, the sweep (f32,
    ragged N and more than 8 rows take the CUDA-core route) and zeros that
    are not whole or lie outside the codes' range, on both routes.  Returns
    the summary and one ``[M, K, N, bits, g, dtype, route, max_abs_err,
    any_zero]`` a case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_cuda,
                                                    plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    main = [(M, K, N, 4, 64, torch.bfloat16) for M in DEQUANT_DECODE_ROWS
            for K, N in sorted(set(QWEN_LINEARS))] + [
        (M, K, N, 4, 64, torch.bfloat16) for M in (1, 4)
        for K, N in new_shapes("linears")
        if (K, N) not in QWEN_LINEARS] + [
        (2, K, N, 4, 64, torch.bfloat16) for K, N in shard_shapes()]
    odd = [(M, K, N, bits, g, torch.bfloat16) for bits in (2, 4, 8)
           for M, K, N, g in DEQUANT_ODD]
    sweep = [(M, K, N, bits, g, dt)
             for bits in (2, 4, 8) for M in (1, 3, 8, 128)
             for dt in (torch.float32, torch.bfloat16)
             for K, N, g in ((256, 200, 32), (384, 128, 64))]
    any_zero = [(M, K, N, bits, g, dt) for bits in (2, 4, 8)
                for M, K, N, g in DEQUANT_ANY_ZERO
                for dt in (torch.float32, torch.bfloat16)]
    main_err, cases, routes = 0.0, [], {}
    first_any = len(main) + len(odd) + len(sweep)
    for i, (M, K, N, bits, g, dt) in enumerate(main + odd + sweep + any_zero):
        packed, s, z = _quantized(torch, K, N, bits, g, dev, gen,
                                  any_zero=i >= first_any)
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        route = plan_for(x, packed, s, z, g).route
        y = dequant_matmul_cuda(x, packed, s, z, bits=bits, group_size=g)
        torch.cuda.synchronize()
        y_ref = ref.dequant_matmul_ref(x, packed, s, z, bits=bits,
                                       group_size=g)
        torch.cuda.synchronize()
        dname = str(dt).split(".")[-1]
        ok, err = within(y, y_ref, TOL[dname])
        what = (f"dequant_matmul M={M} K={K} N={N} bits={bits} g={g} "
                f"{dname} ({route}{', any zero' if i >= first_any else ''})")
        if not ok:
            raise Failed(f"{what}: max err {err}")
        if i < len(main) + len(odd) and route != "mma":
            raise Failed(f"{what}: not on the tensor-core route")
        if i < len(main):
            again = dequant_matmul_cuda(x, packed, s, z, bits=bits,
                                        group_size=g)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise Failed(f"{what}: two runs differ")
            main_err = max(main_err, err)
        routes[route] = routes.get(route, 0) + 1
        cases.append([M, K, N, bits, g, dname, route, err,
                      i >= first_any])
    if set(routes) != {"mma", "fma"}:
        raise Failed(f"dequant_matmul cases missed a route: {routes}")
    return ({"cases": len(cases), "routes": routes, "max_abs_err": main_err,
             "deterministic": True}, cases)


def _rate(nbytes: float, ms: float) -> dict:
    """Achieved bytes/s of a timed run and its share of the HBM rate."""
    gbs = nbytes / ms / 1e6
    return {"gb_per_s": gbs, "hbm_share": gbs * 1e9 / HBM_BYTES_PER_S}


def time_dequant(torch, dev, layers: int = 28) -> dict:
    """One decode step's dequant-matmul calls: 7 linears x ``layers`` at
    M = 4, bf16, 4-bit, group 64, each on its own weights (no L2 reuse)."""
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    M, bits, g = 4, 4, 64
    xs = {K: torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
          for K in (2048, 6144)}
    sets = []
    nbytes = flops = 0
    for _ in range(layers):
        for K, N in QWEN_LINEARS:
            packed = torch.randint(0, 256, (K // 2, N), generator=gen,
                                   device=dev, dtype=torch.uint8)
            s = torch.rand((K // g, N), generator=gen, device=dev) * 1e-2
            z = torch.randint(0, 16, (K // g, N), generator=gen,
                              device=dev).float()
            sets.append((xs[K], packed, s, z))
            nbytes += M * K * 2 + K * N // 2 + 2 * (K // g) * N * 4 + M * N * 2
            flops += 2 * M * K * N
    # the library call's operand: the same weights dequantized to bf16
    dense = [dequantize_int(unpack_codes(p, bits, x.shape[1]), s, z, g,
                            dtype=torch.bfloat16) for x, p, s, z in sets]

    def kernel():
        for x, p, s, z in sets:
            dequant_matmul_cuda(x, p, s, z, bits=bits, group_size=g)

    def plain():
        for x, p, s, z in sets:
            ref.dequant_matmul_ref(x, p, s, z, bits=bits, group_size=g)

    def library():
        for (x, _, _, _), w in zip(sets, dense):
            torch.matmul(x, w)

    ms = time_graph(torch, kernel)
    plain_ms = time_graph(torch, plain)
    library_ms = time_graph(torch, library)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.matmul on the weight pre-dequantized to bf16",
            **bound(nbytes, flops, BF16_FLOPS), **_rate(nbytes, ms),
            "calls": len(sets)}


DEQUANT_SPLITS = (1, 2, 4, 8)


def time_dequant_splits(torch, dev, calls: int = 28) -> dict:
    """The tensor-core route's K split, the data behind ``dqmm_plan``'s
    choice: each Qwen3-1.7B linear at M = 4 (bf16, 4-bit, group 64, each
    call on its own weights) timed at 1, 2, 4 and 8 blocks a cluster (and
    the plan's own split), with the split the plan picks and the fastest."""
    from repro_torch.kernels import build
    from repro_torch.kernels import dequant_matmul as dq
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    M, g = 4, 64
    rows = {}
    for K, N in sorted(set(QWEN_LINEARS)):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        sets = [(torch.randint(0, 256, (K // 2, N), generator=gen,
                               device=dev, dtype=torch.uint8),
                 torch.rand((K // g, N), generator=gen, device=dev) * 1e-2,
                 torch.randint(0, 16, (K // g, N), generator=gen,
                               device=dev).float()) for _ in range(calls)]
        picked = dq.plan_for(x, *sets[0], g)
        row = {}
        for want in sorted(set(DEQUANT_SPLITS) | {picked.splits}):
            plan = dq.dqmm_plan(M, K, N, g, bf16=True, aligned=True, cpt=4,
                                n_sm=build.sm_count(dev), splits=want)

            def run(plan=plan):
                for p, s, z in sets:
                    dq.dequant_matmul_cuda(x, p, s, z, bits=4, group_size=g,
                                           plan=plan)
            row[str(plan.splits)] = 1e3 * time_graph(torch, run) / calls
        rows[f"{K}x{N}"] = {"us_by_splits": row, "plan": picked.splits,
                            "fastest": int(min(row, key=row.get))}
    return {"calls": calls, "rows": rows}


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


# check_flash's decode cases at the path's widths (B 4, Hq 16, Hkv 8,
# d 128, one query row, through the cache's transpose): caches of 1 to 4096
# keys, lengths of 1 and of the cache, and lengths on the tile and split
# boundaries (flash_plan's bulk chunks: 64 keys at a 128-key cache, 1024
# at 4096; tiles of 32 keys)
FLASH_DECODE = ((1, (1, 1, 1, 1)), (127, (127, 1, 64, 96)),
                (128, (128, 32, 64, 1)), (128, (33, 31, 96, 97)),
                (4096, (4096, 3072, 1024, 1)), (4096, (2048, 1025, 1023, 4095)))
# q's scale in the bf16 decode cases.  With q and k N(0, 1) the logits are
# N(0, 1), the softmax is nearly flat and an output is about sqrt(e / n):
# 0.026 at 4096 keys, below the 5e-2 limit itself, so a split's partial
# could go missing unseen.  At 4x the logits are N(0, 16): a few keys
# carry each row, the outputs are O(1) and a lost partial shows.  The f32
# cases stay flat: their 1e-4 limit sees every key.
FLASH_Q_PEAK = 4.0


def check_flash(torch, dev) -> tuple[dict, list]:
    """The kernel against its plain version: the path's case, prefill and
    odd shapes (the tiled route), then the decode cases in bf16 (the bulk
    route, q scaled by ``FLASH_Q_PEAK``) and f32 (the split route), at
    Qwen3-1.7B's heads and at the other configs', each run twice for
    equal bits.  Returns the summary and one ``[B, Hq, Hkv,
    Sq, Sk, d, causal, dtype, route, max_abs_err, max_abs_ref]`` a case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # (B, Hq, Hkv, Sq, Sk, d, causal, lengths, dtype, through_cache)
    cases = [
        (4, 16, 8, 1, 128, 128, False, (128, 97, 40, 1), torch.bfloat16, True),
        (1, 16, 8, 256, 256, 128, True, None, torch.bfloat16, False),
        (2, 4, 2, 128, 128, 16, True, (128, 77), torch.float32, False),
        (2, 4, 2, 1, 64, 16, False, (13, 64), torch.float32, True),
        (1, 8, 2, 384, 384, 64, False, None, torch.float32, False),
        (2, 2, 1, 100, 160, 96, True, (160, 50), torch.float32, False),
    ]
    decode = len(cases)
    cases += [(4, 16, 8, 1, Sk, 128, False, lens, dt, True)
              for Sk, lens in FLASH_DECODE
              for dt in (torch.bfloat16, torch.float32)]
    # the other configs' heads (MHA, GQA group 8, head dim 64) at a
    # 128-key cache
    cases += [(4, Hq, Hkv, 1, 128, d, False, (128, 97, 40, 1), dt, True)
              for Hq, Hkv, d in new_shapes("heads")
              for dt in (torch.bfloat16, torch.float32)]
    main_err, out, routes = 0.0, [], {}
    for i, (B, Hq, Hkv, Sq, Sk, d, causal, lens, dt, cached) in \
            enumerate(cases):
        q = torch.randn((B, Hq, Sq, d), generator=gen, device=dev)
        if i >= decode and dt == torch.bfloat16:
            q = q * FLASH_Q_PEAK
        q = q.to(dt)
        if cached:      # decode layout: (B, Sk, Hkv, d) read transposed
            k = torch.randn((B, Sk, Hkv, d), generator=gen,
                            device=dev).to(dt).transpose(1, 2)
            v = torch.randn((B, Sk, Hkv, d), generator=gen,
                            device=dev).to(dt).transpose(1, 2)
        else:
            k = torch.randn((B, Hkv, Sk, d), generator=gen, device=dev).to(dt)
            v = torch.randn((B, Hkv, Sk, d), generator=gen, device=dev).to(dt)
        lengths = (None if lens is None else
                   torch.tensor(lens, dtype=torch.int32, device=dev))
        route = plan_for(q, k, v).route
        o = flash_attention_cuda(q, k, v, causal=causal, lengths=lengths)
        torch.cuda.synchronize()
        o_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                        lengths=lengths)
        torch.cuda.synchronize()
        dname = str(dt).split(".")[-1]
        ok, err = within(o, o_ref, TOL_ATTN[dname])
        what = (f"flash_attention case {i} {(B, Hq, Hkv, Sq, Sk, d)} "
                f"lengths={lens} causal={causal} {dname} ({route})")
        if not ok:
            raise Failed(f"{what}: max err {err}")
        if Sq == 1 and cached:
            if route not in ("bulk", "split"):
                raise Failed(f"{what}: keys not split over a cluster")
            again = flash_attention_cuda(q, k, v, causal=causal,
                                         lengths=lengths)
            torch.cuda.synchronize()
            if not torch.equal(o, again):
                raise Failed(f"{what}: two runs differ")
        if i == 0:
            main_err = err
        routes[route] = routes.get(route, 0) + 1
        out.append([B, Hq, Hkv, Sq, Sk, d, causal, dname, route, err,
                    float(o_ref.float().abs().max())])
    if set(routes) != {"bulk", "split", "tiled"}:
        raise Failed(f"flash_attention cases missed a route: {routes}")
    return ({"cases": len(cases), "routes": routes, "max_abs_err": main_err,
             "deterministic": True}, out)


# the partial mode's cases (the sequence-sharded decode's softmax over a
# rank's keys): (B, Hq, Hkv, keys a rank, d, dtype, lengths), one query
# row through the cache's transpose.  Lengths 0 (a rank whose shard lies
# past idx), 1 and the shard's whole T.  bf16 d 128 and 64 take the "bulk"
# route, f32 the "split" one; seq_kv's shard (Qwen3-30B-A3B on model 8:
# every q head, 4 KV heads, 8 keys), decode_32k's production shard
# (Qwen3-1.7B on one rank of 16 x 16: 8 rows, 16 q heads after the
# gather, 8 KV heads, 2048 keys) and a ragged one (1000 keys: each
# block's last tile of 32 keys is short, as are most rows' last tiles)
FLASH_PARTIAL = (
    (4, 16, 8, 128, 128, "bfloat16", (0, 1, 128, 57)),
    (4, 16, 8, 128, 128, "float32", (0, 1, 128, 33)),
    (4, 36, 36, 128, 64, "bfloat16", (1, 0, 128, 77)),
    (4, 32, 4, 8, 128, "bfloat16", (0, 1, 8, 5)),
    (8, 16, 8, 2048, 128, "bfloat16",
     (2048, 0, 1, 1500, 2048, 2047, 640, 33)),
    (8, 16, 8, 2048, 128, "float32", (2048, 0, 1, 1500, 2048, 2047, 640, 33)),
    (8, 16, 8, 1000, 128, "bfloat16", (1000, 0, 999, 1, 513, 33, 967, 32)),
)
# the log-sum-exp against the plain version's, absolute, over rows with a
# valid key: f32 as the issue's bound; bf16 from the prediction written
# before its first run (PERF.md): the bulk route's scores are exact
# products of bf16 operands summed in f32, so only the summation order
# differs from the plain f32 einsum, ~1e-6 of logits of O(10)
FLASH_LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


def check_flash_partial(torch, dev) -> tuple[dict, list]:
    """The partial mode (``return_lse``) against the plain version's:
    ``out`` within the JAX tolerances (bf16 q scaled by
    ``FLASH_Q_PEAK``), ``lse`` within ``FLASH_LSE_TOL`` over rows with a
    valid key, and a row of length 0 exactly ``out`` 0 and ``lse`` -inf,
    as in the plain version; each case run twice for equal bits.  Returns
    the summary and one ``[B, Hq, Hkv, Sk, d, dtype, route, max_abs_err,
    lse_err, zero_rows]`` a case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out, worst, lse_worst, routes = [], 0.0, {}, {}
    for B, Hq, Hkv, T, d, dname, lens in FLASH_PARTIAL:
        dt = getattr(torch, dname)
        q = torch.randn((B, Hq, 1, d), generator=gen, device=dev)
        q = (q * FLASH_Q_PEAK if dt == torch.bfloat16 else q).to(dt)
        k, v = (torch.randn((B, T, Hkv, d), generator=gen, device=dev)
                .to(dt).transpose(1, 2) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        route = plan_for(q, k, v).route
        o, lse = flash_attention_cuda(q, k, v, causal=False,
                                      lengths=lengths, return_lse=True)
        o2, lse2 = flash_attention_cuda(q, k, v, causal=False,
                                        lengths=lengths, return_lse=True)
        o_ref, lse_ref = ref.flash_attention_ref(
            q, k, v, causal=False, lengths=lengths, return_lse=True)
        torch.cuda.synchronize()
        what = (f"flash_attention partial {(B, Hq, Hkv, T, d)} {dname} "
                f"lengths={lens} ({route})")
        live = lengths > 0
        ok, err = within(o[live], o_ref[live], TOL_ATTN[dname])
        lse_err = float((lse[live] - lse_ref[live]).abs().max())
        zero = ~live
        zero_exact = bool((o[zero] == 0).all()) and bool(
            torch.isneginf(lse[zero]).all()) and bool(
            torch.isneginf(lse_ref[zero]).all()) and bool(
            (o_ref[zero] == 0).all())
        if not ok:
            raise Failed(f"{what}: out max err {err}")
        if not lse_err <= FLASH_LSE_TOL[dname]:
            raise Failed(f"{what}: lse max err {lse_err}")
        if not zero_exact:
            raise Failed(f"{what}: a row of no valid key is not out 0, "
                         "lse -inf")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise Failed(f"{what}: two runs differ")
        want = "bulk" if dt == torch.bfloat16 and d in (64, 128) else "split"
        if route != want:
            raise Failed(f"{what}: route {route}, not {want}")
        routes[route] = routes.get(route, 0) + 1
        worst = max(worst, err)
        lse_worst[dname] = max(lse_worst.get(dname, 0.0), lse_err)
        out.append([B, Hq, Hkv, T, d, dname, route, err, lse_err,
                    int(zero.sum())])
    return ({"cases": len(out), "routes": routes, "max_abs_err": worst,
             "lse_max_abs_err": lse_worst, "lse_tol": FLASH_LSE_TOL,
             "zero_rows_exact": True, "deterministic": True}, out)


# the plans time_flash_partial also times at the production shard, (splits,
# stages) of the bulk route: 1, 2, 4 and 8 blocks a cluster with the
# plan's ring, and 4 stages at the plan's split (the data behind
# flash_plan's bulk split and ring)
FLASH_PARTIAL_PLANS = ((1, None), (2, None), (4, None), (8, None), (None, 4))
# the rows' lengths it also times the plan at: no key (a call's fixed
# cost), one tile, half and all of the shard (the stream's marginal rate)
FLASH_PARTIAL_LENGTHS = (0, 32, 1024, 2048)


def time_flash_partial(torch, dev, layers: int = 28,
                       sweep: bool = True) -> dict:
    """The partial mode at decode_32k's production shard of Qwen3-1.7B
    (one rank of 16 x 16: 8 rows, 16 q heads after the gather, 8 KV heads,
    2048 keys a rank, d 128, bf16, the shard's every key valid), one call
    a layer over ``layers`` layers, each on its own cache shard read
    through the decode path's transpose.  Bytes: the keys and values, q,
    the output and the lse; operations 4 a key, q head and dim.  Library:
    SDPA on the same shard (no lse).  ``by_plan`` (``sweep``): the same
    calls on each of :data:`FLASH_PARTIAL_PLANS` ("splits x stages");
    ``us_by_length``: µs a call with every row at each of
    :data:`FLASH_PARTIAL_LENGTHS`, and ``marginal_gb_per_s``: the bytes
    of the shard's second half over the time they add."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    B, Hq, Hkv, T, d = 8, 16, 8, 2048, 128
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    sets = []
    for _ in range(layers):
        q = torch.randn((B, 1, Hq, d), generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((B, T, Hkv, d), generator=gen, device=dev)
                .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        sets.append((q, k, v))
    nbytes = layers * (2 * B * T * Hkv * d * 2 + 2 * B * Hq * d * 2
                       + B * Hq * 4 + B * 4)
    flops = layers * 4 * B * T * Hq * d

    def kernel(lengths=lengths, **plan):
        for q, k, v in sets:
            flash_attention_cuda(q, k, v, causal=False, lengths=lengths,
                                 return_lse=True, **plan)

    def plain():
        for q, k, v in sets:
            ref.flash_attention_ref(q, k, v, causal=False, lengths=lengths,
                                    return_lse=True)

    def library():
        for q, k, v in sets:
            _sdpa(torch, q, k, v, None)

    ms = time_graph(torch, kernel)
    plain_ms = time_graph(torch, plain)
    library_ms = time_graph(torch, library)
    plan = plan_for(*sets[0])
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention on the same shard",
           **bound(nbytes, flops, BF16_FLOPS), **_rate(nbytes, ms),
           "calls": layers, "shard": [B, Hq, Hkv, T, d],
           "route": plan.route, "splits": plan.splits}
    if sweep:
        out["stages"] = plan.stages
        out["by_plan"] = {}
        for splits, stages in FLASH_PARTIAL_PLANS:
            p = plan_for(*sets[0], splits=splits, stages=stages)
            out["by_plan"][f"{p.splits}x{p.stages}"] = time_graph(
                torch, functools.partial(kernel, plan=p))
        us = {n: 1e3 * time_graph(torch, functools.partial(
            kernel, torch.full((B,), n, dtype=torch.int32, device=dev)))
            / layers for n in FLASH_PARTIAL_LENGTHS}
        out["us_by_length"] = us
        half = 2 * B * (T // 2) * Hkv * d * 2
        out["marginal_gb_per_s"] = half / (us[T] - us[T // 2]) / 1e3
    return out


def _sdpa(torch, q, k, v, mask):
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:           # torch without enable_gqa
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask)


def time_flash(torch, dev, layers: int = 28, T: int = 128,
               lens: tuple = (128, 97, 40, 1), sweep: bool = True) -> dict:
    """One decode step's attention calls: ``layers`` calls at B = 4, Hq = 16,
    Hkv = 8, Sq = 1, a cache of ``T`` keys, d = 128, bf16, mixed lengths,
    each on its own KV cache read through the decode path's transpose.
    Bytes are the keys and values the lengths reach, q and the output.
    ``by_splits`` (``sweep``): the same calls at 1, 2, 4 and 8 blocks a
    cluster ("splits x stages")."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    B, Hq, Hkv, d = 4, 16, 8, 128
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    sets = []
    for _ in range(layers):
        q = torch.randn((B, 1, Hq, d), generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        k = torch.randn((B, T, Hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        v = torch.randn((B, T, Hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        sets.append((q, k, v))
    keys = sum(lens)
    nbytes = layers * (2 * keys * Hkv * d * 2 + 2 * B * Hq * d * 2 + B * 4)
    flops = layers * 4 * keys * Hq * d

    def kernel():
        for q, k, v in sets:
            flash_attention_cuda(q, k, v, causal=False, lengths=lengths)

    def plain():
        for q, k, v in sets:
            ref.flash_attention_ref(q, k, v, causal=False, lengths=lengths)

    def library():
        for q, k, v in sets:
            _sdpa(torch, q, k, v, mask)

    ms = time_graph(torch, kernel)
    plain_ms = time_graph(torch, plain)
    library_ms = time_graph(torch, library)
    plan = plan_for(*sets[0])

    def planned(p):
        for q, k, v in sets:
            flash_attention_cuda(q, k, v, causal=False, lengths=lengths,
                                 plan=p)

    out = {"route": plan.route, "splits": plan.splits}
    if sweep:
        out["stages"] = plan.stages
        out["by_splits"] = {}
        for n in (1, 2, 4, 8):
            p = plan_for(*sets[0], splits=n)
            out["by_splits"][f"{p.splits}x{p.stages}"] = time_graph(
                torch, functools.partial(planned, p))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **out,
            "library": "scaled_dot_product_attention with the same mask",
            **bound(nbytes, flops, BF16_FLOPS), **_rate(nbytes, ms),
            "calls": len(sets), "cache": T, "lengths": list(lens),
            "cache_gb": layers * 2 * B * T * Hkv * d * 2 / 1e9}


# ---------------------------------------------------------------------------
# gram
# ---------------------------------------------------------------------------

# the fine-tuning run's calibration: T = 8 x 128 tokens a batch; per layer
# the inputs of q, k, v, o, gate, up (D = 2048) and down (D = 6144)
TRAIN_TOKENS = 8 * 128
GRAM_DIMS = (2048,) * 6 + (6144,)

# rows of the enc-dec and vision paths' calls besides TRAIN_TOKENS:
# seamless's encoder and cross-attention k/v in training (8 x 32 frames),
# its cross k/v in decode (4 slots x a 128-position encoder output, the
# fused kernel's rows), pixtral's training rows (8 x (256 patches + 128
# tokens))
ENC_ROWS = 8 * 32
CROSS_DECODE_ROWS = 4 * 128
VLM_ROWS = 8 * (256 + 128)


def path_cases() -> dict:
    """The enc-dec and vision paths' shapes at those rows: ``lora`` (M, K,
    N) of the fused kernel, ``grams`` (T, D) of ``gram``."""
    from repro_torch.configs import get_config
    sm = get_config("seamless-m4t-medium")
    s_, p_ = config_shapes(sm), config_shapes(get_config("pixtral-12b"))
    return {"lora": [(ENC_ROWS, K, N) for K, N in s_["linears"]] +
            [(CROSS_DECODE_ROWS, sm.d_model, sm.n_kv_heads * sm.head_dim)] +
            [(VLM_ROWS, K, N) for K, N in p_["linears"]],
            "grams": [(ENC_ROWS, D) for D in s_["grams"]] +
            [(VLM_ROWS, D) for D in p_["grams"]]}


@functools.cache
def shard_shapes() -> tuple:
    """(K, N) of the quantized linears of ``train_sharded``'s families on a
    rank of its (data 2, model 2) mesh, as ``launch.shardings.
    param_specs`` lays out each linear's weight by its role (a column
    linear keeps N / 2, a row one K / 2); the replicated ones (Mamba's bc
    and dt projections) are whole, as in the cases above and left out."""
    import dataclasses
    import types
    from repro_torch.core.pipeline import quantizable_linear_paths
    from repro_torch.launch.shardings import param_specs
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import get_path
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=SHARDED_MESH)
    out = set()
    for arch, layers, _ in SHARDED_FAMILIES:
        meta = init_params(dataclasses.replace(
            _family_config(arch, layers), scan_layers=False), device="meta")
        specs = param_specs(meta, mesh)
        for path in quantizable_linear_paths(meta):
            w, spec = get_path(meta, path)["w"], get_path(specs, path)["w"]
            if w.dim() == 2 and "model" in spec:
                out.add(tuple(n // SHARDED_MESH[1] if ax == "model" else n
                              for n, ax in zip(w.shape, spec)))
    return tuple(sorted(out))


def kernels_phase(torch, dev) -> dict:
    """The whole script's kernel checks without its timings (each
    kernel's cases against its plain version; a case that disagrees
    raises), with the cases at ``train_sharded``'s shard shapes
    (:func:`shard_shapes`) listed."""
    shards = set(shard_shapes())
    dq, dq_cases = check_dequant(torch, dev)
    lo, lo_cases = check_lora(torch, dev)
    fp, fp_cases = check_flash_partial(torch, dev)
    return {"dequant_matmul": dq,
            "flash_attention": check_flash(torch, dev)[0],
            "flash_partial": {**fp, "cases_list": fp_cases},
            "gram": check_gram(torch, dev)[0], "dequant_matmul_lora": lo,
            "shard_cases": {
                "dequant_matmul": [c for c in dq_cases if c[0] == 2
                                   and tuple(c[1:3]) in shards],
                "dequant_matmul_lora": [c for c in lo_cases
                                        if c[0] == TRAIN_TOKENS // 2
                                        and tuple(c[1:3]) in shards]}}


def lora_phase(torch, dev) -> dict:
    """The fused kernel alone, as the default run checks and times it: its
    cases on every route, ``lora_precision``, the training forward's
    timing by shape (``time_lora``) and the fused-or-unfused sweep behind
    ``ops.FUSED_LORA_MIN_ROWS`` (``time_lora_routes``)."""
    summary, _ = check_lora(torch, dev)
    return {"dequant_matmul_lora": {**summary, **time_lora(torch, dev)},
            "lora_precision": lora_precision(torch, dev),
            "lora_route": time_lora_routes(torch, dev)}


# check_gram's cases for the tensor-core route beyond the main ones: T
# ragged around the 64-token stage and past it, D cut inside a 128-column
# tile (136, 2056: 8 columns into the last one; 8: one tile mostly past D)
GRAM_WGMMA = ((1, 2048), (63, 136), (65, 2056), (1000, 2056), (4096, 136),
              (129, 8), (1000, 6144))


# MoE expert slices (C, D) of a calibration batch of 8 x 128 tokens:
# OLMoE's (C = 1024 x 8 x 1.25 / 64 = 160, D 2048 and 1024) and
# Qwen3-30B-A3B's (C = 80 of 128 experts, D 2048 and 768)
GRAM_EXPERT_SLICES = ((160, 2048), (160, 1024), (80, 2048), (80, 768))


def check_gram(torch, dev) -> tuple[dict, list]:
    """The kernel against its plain version: the main cases (T = 1024, D =
    2048 and 6144, bf16 run twice for equal bits, and f32), the
    tensor-core route's ragged cases, the other configs' widths, MoE
    expert slices and the enc-dec and vision paths' rows, and the sweep (f32 and D % 8 != 0
    take the CUDA-core route).  Every case exactly symmetric; the bf16
    cases on the wgmma route also within the f32 tolerance (their products
    are exact, so a lost token stage or a wrong swizzle cannot hide in
    the bf16 one).  Returns the summary and one ``[T, D, dtype, route,
    max_abs_err, max_abs_ref, within_f32_tol]`` a case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram_cuda, plan_for
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    main = [(TRAIN_TOKENS, D, dt) for D in (2048, 6144)
            for dt in (torch.bfloat16, torch.float32)]
    wgmma = [(T, D, torch.bfloat16) for T, D in GRAM_WGMMA] + [
        (TRAIN_TOKENS, D, torch.bfloat16) for D in new_shapes("grams")
        if D not in GRAM_DIMS] + [
        (T, D, torch.bfloat16) for T, D in GRAM_EXPERT_SLICES] + [
        (T, D, torch.bfloat16) for T, D in path_cases()["grams"]]
    sweep = [(T, D, dt) for T, D in ((1, 64), (1, 50), (37, 50), (300, 130),
                                     (129, 65), (1000, 2047), (64, 1))
             for dt in (torch.float32, torch.bfloat16)]
    main_err, cases, routes = 0.0, [], {}
    for i, (T, D, dt) in enumerate(main + wgmma + sweep):
        x = torch.randn((T, D), generator=gen, device=dev).to(dt)
        route = plan_for(x).route
        h = gram_cuda(x)
        torch.cuda.synchronize()
        h_ref = ref.gram_ref(x)
        torch.cuda.synchronize()
        dname = str(dt).split(".")[-1]
        ok, err = within(h, h_ref, TOL_GRAM[dname])
        ok32 = within(h, h_ref, TOL_GRAM["float32"])[0]
        what = f"gram T={T} D={D} {dname} ({route})"
        if not ok or not torch.equal(h, h.T):
            raise Failed(f"{what}: max err {err}, symmetric "
                         f"{bool(torch.equal(h, h.T))}")
        if route == "wgmma" and not ok32:
            raise Failed(f"{what}: max err {err} outside the f32 tolerance "
                         "(exact products)")
        if dt == torch.bfloat16 and i < len(main) + len(wgmma) and \
                route != "wgmma":
            raise Failed(f"{what}: not on the tensor-core route")
        if i < len(main) and dt == torch.bfloat16:
            again = gram_cuda(x)
            torch.cuda.synchronize()
            if not torch.equal(h, again):
                raise Failed(f"{what}: two runs differ")
            main_err = max(main_err, err)
        routes[route] = routes.get(route, 0) + 1
        cases.append([T, D, dname, route, err,
                      float(h_ref.abs().max()), ok32])
    if set(routes) != {"wgmma", "fma"}:
        raise Failed(f"gram cases missed a route: {routes}")
    return ({"cases": len(cases), "routes": routes, "max_abs_err": main_err,
             "deterministic": True}, cases)


def _gram_sets(torch, dev, gen, layers: int):
    """One calibration batch's Gram operands: 7 x ``layers`` at T = 1024,
    bf16, as ``GramStore.add`` makes them (q, k and v see the same x, as do
    gate and up), with their bytes and operations."""
    T = TRAIN_TOKENS
    sets, nbytes, flops = [], 0, 0
    for _ in range(layers):
        xs = {D: torch.randn((T, D), generator=gen,
                             device=dev).to(torch.bfloat16)
              for D in set(GRAM_DIMS)}
        for D in GRAM_DIMS:
            sets.append(xs[D])
            nbytes += T * D * 2 + D * D * 4
            flops += T * D * (D + 1)        # H is symmetric: i <= j only
    return sets, nbytes, flops


def time_gram(torch, dev, layers: int = 28) -> dict:
    """One calibration batch's Gram calls (:func:`_gram_sets`): the kernel,
    the plain version and the bf16 library call that computes the same
    function (bf16 products, f32 sums and output, the whole square), with
    the f32 matmul ``GramStore.add`` ran before the kernel beside it; the
    plan at each D, TFLOP/s on the triangle and the share of the bound."""
    import dataclasses
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram_cuda, plan_for
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    sets, nbytes, flops = _gram_sets(torch, dev, gen, layers)

    def kernel():
        for x in sets:
            gram_cuda(x)

    def plain():
        for x in sets:
            ref.gram_ref(x)

    def library():
        for x in sets:
            torch.mm(x.T, x, out_dtype=torch.float32)

    def library_f32():
        for x in sets:
            torch.matmul(x.float().T, x.float())

    ms = time_graph(torch, kernel)
    plain_ms = time_graph(torch, plain)
    library_ms = time_graph(torch, library)
    library_f32_ms = time_graph(torch, library_f32)
    b = bound(nbytes, flops, BF16_FLOPS)
    plans = {str(D): dataclasses.asdict(plan_for(x))
             for D, x in ((2048, sets[0]), (6144, sets[6]))}
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.mm(x.T, x, out_dtype=torch.float32): bf16 "
                       "products, f32 sums, the whole square",
            "library_f32_ms": library_f32_ms,
            "library_f32": "f32 torch.matmul(x.float().T, x.float())",
            **b, "calls": len(sets), "tflops": flops / ms / 1e9,
            "bound_share": b["bound_ms"] / ms, "plans": plans}


GRAM_GRIDS = (33, 66, 99, 132)


def time_gram_tiles(torch, dev, calls: int = 28) -> dict:
    """The data behind ``gram_plan``'s grid: the tensor-core route at each
    calibration width (T = 1024, bf16, each call on its own x) with 1/4 to
    all of the SMs' worth of persistent blocks (``GRAM_GRIDS``) and the
    plan's own: microseconds a call, each grid's microseconds a tile a
    block (time over the rounds of tiles a block walks), the plan's grid
    and the fastest."""
    from repro_torch.kernels import build
    from repro_torch.kernels import gram as gm
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    n_sm = build.sm_count(dev)
    rows = {}
    for D in sorted(set(GRAM_DIMS)):
        xs = [torch.randn((TRAIN_TOKENS, D), generator=gen,
                          device=dev).to(torch.bfloat16)
              for _ in range(calls)]
        picked = gm.plan_for(xs[0])
        us, per_tile = {}, {}
        for want in sorted(set(GRAM_GRIDS) | {picked.grid}):
            plan = gm.gram_plan(TRAIN_TOKENS, D, bf16=True, aligned=True,
                                n_sm=n_sm, grid=want)

            def run(plan=plan):
                for x in xs:
                    gm.gram_cuda(x, plan=plan)
            us[str(plan.grid)] = 1e3 * time_graph(torch, run) / calls
            per_tile[str(plan.grid)] = us[str(plan.grid)] / \
                -(-plan.tiles // plan.grid)
        rows[str(D)] = {"tiles": picked.tiles, "us_by_grid": us,
                        "us_a_tile_round": per_tile, "plan": picked.grid,
                        "fastest": int(min(us, key=us.get))}
    return {"calls": calls, "rows": rows}


# ---------------------------------------------------------------------------
# dequant_matmul_lora
# ---------------------------------------------------------------------------


def _lora_operands(torch, M, K, N, bits, g, r, dt, dev, gen,
                   w_std: float = 0.02, any_zero: bool = False):
    packed, s, z = _quantized(torch, K, N, bits, g, dev, gen,
                              any_zero=any_zero, w_std=w_std)
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    a = (torch.randn((K, r), generator=gen, device=dev) / K ** 0.5).to(dt)
    b = (torch.randn((N, r), generator=gen, device=dev) * 0.1).to(dt)
    return x, packed, s, z, a, b


# check_lora's sweep: every route (wgmma where TMA can address the
# operands, mma where it cannot: N % 16, group 48 or 8; fma for f32), row
# counts at and around the 128-row tile edge, N not a multiple of the
# tile, ranks 0 to 128 and K = 6144
LORA_SWEEP_ROWS = (1, 4, 127, 128, 129, 1000, 1024, 4096)
LORA_SWEEP_SHAPES = ((2048, 1024, 64), (6144, 2048, 64), (2048, 6144, 32),
                     (1024, 2048, 128), (256, 130, 32), (384, 200, 64),
                     (96, 40, 48), (512, 1024, 8))
LORA_SWEEP_BITS_RANKS = ((4, 0), (4, 8), (4, 64), (4, 128), (2, 8), (2, 64),
                         (8, 8), (8, 64))


def check_lora(torch, dev) -> tuple[dict, list]:
    """The fused kernel against its plain version: the train shapes
    (Qwen3-1.7B's linears in bf16 and f32, the other configs' in bf16 at
    rank 64, or N where CLoQ cuts the rank to N (Mamba2's dt_proj: 32),
    the enc-dec and vision paths' rows, seamless's cross k/v decode and
    Pixtral's ``down`` at K = 14336 among them, with weights of std 0.02
    and again of std ``K ** -0.5`` as ``init_params`` draws them, see
    :func:`lora_precision`; run twice: the same bits both times) and the
    sweep (weights of std 0.02).  Returns the summary and one
    ``[M, K, N, bits, g, r, dtype, route, max_abs_err, w_std]`` a
    case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_lora_cuda,
                                                    lora_plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    main = [(TRAIN_TOKENS, K, N, 4, 64, 64, dt, 0.02) for K, N in
            sorted(set(QWEN_LINEARS)) for dt in (torch.bfloat16,
                                                 torch.float32)] + [
        (TRAIN_TOKENS, K, N, 4, 64, min(64, N), torch.bfloat16, 0.02)
        for K, N in new_shapes("linears") if (K, N) not in QWEN_LINEARS] + [
        (M, K, N, 4, 64, 64, torch.bfloat16, w_std)
        for M, K, N in path_cases()["lora"] for w_std in (0.02, K ** -0.5)] + [
        (TRAIN_TOKENS // 2, K, N, 4, 64, 64, torch.bfloat16, 0.02)
        for K, N in shard_shapes()]
    sweep = [(M, K, N, bits, g, r, dt, 0.02)
             for M in LORA_SWEEP_ROWS for K, N, g in LORA_SWEEP_SHAPES
             for bits, r in LORA_SWEEP_BITS_RANKS
             for dt in (torch.bfloat16, torch.float32)]
    main_err, cases, routes = 0.0, [], {}
    for i, (M, K, N, bits, g, r, dt, w_std) in enumerate(main + sweep):
        x, packed, s, z, a, b = _lora_operands(torch, M, K, N, bits, g, r,
                                               dt, dev, gen, w_std)
        route = lora_plan_for(x, packed, s, z, a, b, g).route
        y = dequant_matmul_lora_cuda(x, packed, s, z, a, b, bits=bits,
                                     group_size=g)
        torch.cuda.synchronize()
        y_ref = ref.dequant_matmul_lora_ref(x, packed, s, z, a, b,
                                            bits=bits, group_size=g)
        torch.cuda.synchronize()
        dname = str(dt).split(".")[-1]
        ok, err = within(y, y_ref, TOL[dname])
        what = (f"dequant_matmul_lora M={M} K={K} N={N} bits={bits} g={g} "
                f"r={r} {dname} ({route})")
        if not ok:
            raise Failed(f"{what}: max err {err}")
        if i < len(main):
            again = dequant_matmul_lora_cuda(x, packed, s, z, a, b,
                                             bits=bits, group_size=g)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise Failed(f"{what}: two runs differ")
            if dt == torch.bfloat16:
                main_err = max(main_err, err)
        routes[route] = routes.get(route, 0) + 1
        cases.append([M, K, N, bits, g, r, dname, route, err, w_std])
    if set(routes) != {"wgmma", "mma", "fma"}:
        raise Failed(f"dequant_matmul_lora sweep missed a route: {routes}")
    return ({"cases": len(cases), "routes": routes, "max_abs_err": main_err,
             "deterministic": True}, cases)


# lora_precision's cases: Pixtral's down projection at its training rows and
# Zamba2's at 1024 (K = 14336), at the sweep's weight std and at the
# model's (``init_params``: K ** -0.5), 4-bit with the quantizer's zeros;
# then Zamba2's at every bits with zeros that are not whole and some past
# the codes' range (``_quantized(any_zero=True)``): the wgmma route's
# zero fraction, -s (z - round(z)), carried on the tensor cores
LORA_PRECISION = ((VLM_ROWS, 14336, 5120), (TRAIN_TOKENS, 14336, 3584))
LORA_PRECISION_ANY_ZERO = (TRAIN_TOKENS, 14336, 3584)
# the kernel against the exact product: one bf16 rounding of its output
# (2^-8 relative covers it with room) and its f32 sums' error
LORA_EXACT_RTOL, LORA_EXACT_ATOL = 2.0 ** -8, 1e-3


def lora_precision_rows(torch, dev) -> list:
    """One row a ``LORA_PRECISION`` case and weight std, and one a bits and
    weight std of ``LORA_PRECISION_ANY_ZERO`` (see :func:`lora_precision`),
    ``holds`` saying whether it meets both bounds on the wgmma route."""
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_lora_cuda,
                                                    lora_plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = []
    f64 = torch.float64
    cases = [(M, K, N, 4, w_std, False) for M, K, N in LORA_PRECISION
             for w_std in (0.02, K ** -0.5)]
    M, K, N = LORA_PRECISION_ANY_ZERO
    cases += [(M, K, N, bits, w_std, True) for bits in (2, 4, 8)
              for w_std in (0.02, K ** -0.5)]
    for M, K, N, bits, w_std, any_zero in cases:
        x, packed, s, z, a, b = _lora_operands(
            torch, M, K, N, bits, 64, 64, torch.bfloat16, dev, gen, w_std,
            any_zero=any_zero)
        route = lora_plan_for(x, packed, s, z, a, b, 64).route
        y = dequant_matmul_lora_cuda(x, packed, s, z, a, b, bits=bits,
                                     group_size=64).to(f64)
        y_ref = ref.dequant_matmul_lora_ref(x, packed, s, z, a, b,
                                            bits=bits, group_size=64).to(f64)
        W = dequantize_int(unpack_codes(packed, bits, K), s, z, 64,
                           dtype=f64)
        exact = x.to(f64) @ W + (x.to(f64) @ a.to(f64)) @ b.to(f64).T
        del W
        rtol, atol = TOL["bfloat16"]
        outside = (y - y_ref).abs() > atol + rtol * y_ref.abs()
        err = (y - exact).abs()
        beyond = err > LORA_EXACT_RTOL * exact.abs() + LORA_EXACT_ATOL
        row = {"M": M, "K": K, "N": N, "bits": bits, "w_std": w_std,
               "any_zero": any_zero, "route": route,
               "out_std": float(exact.std()),
               "kernel_vs_exact": float(err.max()),
               "plain_vs_exact": float((y_ref - exact).abs().max()),
               "beyond_exact_bound": int(beyond.sum()),
               "outside_jax_tol_vs_plain": int(outside.sum())}
        row["holds"] = route == "wgmma" and not (
            row["beyond_exact_bound"] or row["outside_jax_tol_vs_plain"])
        out.append(row)
        del x, packed, s, z, a, b, y, y_ref, exact, err, beyond, outside
        torch.cuda.empty_cache()
    return out


def lora_precision(torch, dev) -> dict:
    """What the wgmma route computes at K = 14336, where a weight rounded to
    bf16 once put outputs outside the JAX bf16 tolerance.  The kernel sums
    exact products of exact codes a group in f32 and folds each group with
    its f32 scale and zero, so it is held to the exact product (f64) within
    ``LORA_EXACT_RTOL * |exact| + LORA_EXACT_ATOL``, and against the plain
    version to the JAX bf16 tolerance (no element outside), at both weight
    stds, and with zeros that are not whole or lie past the codes' range
    at bits 2, 4 and 8 (the route keeps about 16 bits of the zero's
    fraction: bf16 halves on the tensor cores).  Reported beside: kernel and plain version against the exact
    product, and the outputs' std (0.02 sqrt(K), 2.4 here, at std 0.02; 1
    at the model's)."""
    rows = lora_precision_rows(torch, dev)
    if not all(r["holds"] for r in rows):
        raise Failed(f"lora_precision: {rows}")
    return {"cases": rows, "exact_rtol": LORA_EXACT_RTOL,
            "exact_atol": LORA_EXACT_ATOL}


def time_lora(torch, dev, layers: int = 28) -> dict:
    """One training forward's fused calls: 7 linears x ``layers`` at
    M = 1024, bf16, 4-bit, group 64, rank 64, each on its own weights;
    with each shape's route and tiling (``plans``), and ``by_shape``: each
    distinct (K, N) of ``QWEN_LINEARS`` timed alone, its calls over the
    ``layers`` (kernel, bound and library ms, its plan)."""
    import dataclasses
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_lora_cuda,
                                                    lora_plan_for)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    M, bits, g, r = TRAIN_TOKENS, 4, 64, 64
    bf = torch.bfloat16
    xs = {K: torch.randn((M, K), generator=gen, device=dev).to(bf)
          for K in {K for K, _ in QWEN_LINEARS}}
    sets, plans, work = [], {}, {}
    for _ in range(layers):
        for K, N in QWEN_LINEARS:
            packed = torch.randint(0, 256, (K // 2, N), generator=gen,
                                   device=dev, dtype=torch.uint8)
            s = torch.rand((K // g, N), generator=gen, device=dev) * 1e-2
            z = torch.randint(0, 16, (K // g, N), generator=gen,
                              device=dev).float()
            a = (torch.randn((K, r), generator=gen, device=dev)
                 / K ** 0.5).to(bf)
            b = (torch.randn((N, r), generator=gen, device=dev)
                 * 0.1).to(bf)
            sets.append((xs[K], packed, s, z, a, b))
            key = f"{K}x{N}"
            plans.setdefault(key, dataclasses.asdict(
                lora_plan_for(xs[K], packed, s, z, a, b, g)))
            w = work.setdefault(key, [0, 0, 0, 0])
            w[0] += 1
            w[1] += (M * K * 2 + K * N // 2 + 2 * (K // g) * N * 4
                     + (K + N) * r * 2 + M * N * 2)
            w[2] += 2 * M * K * N + 2 * M * r * (K + N)
            # the wgmma route runs (x @ A) @ B^T as [hi | lo] @ [B^T; B^T]
            # (2 * M * N * r more products, left out of the bound)
            w[3] += 2 * M * N * r
    dense = [dequantize_int(unpack_codes(p, bits, x.shape[1]), s, z, g,
                            dtype=bf) for x, p, s, z, _, _ in sets]

    def kernel(calls):
        def run():
            for x, p, s, z, a, b in calls:
                dequant_matmul_lora_cuda(x, p, s, z, a, b, bits=bits,
                                         group_size=g)
        return run

    def plain():
        for x, p, s, z, a, b in sets:
            ref.dequant_matmul_lora_ref(x, p, s, z, a, b, bits=bits,
                                        group_size=g)

    def library(calls):
        def run():
            for (x, _, _, _, a, b), w in calls:
                torch.matmul(x, w) + torch.matmul(torch.matmul(x, a), b.T)
        return run

    ms = time_graph(torch, kernel(sets), reps=5)
    plain_ms = time_graph(torch, plain, reps=5)
    library_ms = time_graph(torch, library(list(zip(sets, dense))), reps=5)
    nbytes, flops, lora_flops = (sum(w[i] for w in work.values())
                                 for i in (1, 2, 3))
    b = bound(nbytes, flops, BF16_FLOPS)
    shapes = {}
    for key, (calls, nb, fl, _) in work.items():
        mine = [i for i, (x, p, *_) in enumerate(sets)
                if f"{x.shape[1]}x{p.shape[1]}" == key]
        k_ms = time_graph(torch, kernel([sets[i] for i in mine]), reps=5)
        l_ms = time_graph(torch, library(
            [(sets[i], dense[i]) for i in mine]), reps=5)
        sb = bound(nb, fl, BF16_FLOPS)
        shapes[key] = {"calls": calls, "ms": k_ms,
                       "bound_ms": sb["bound_ms"],
                       "bound_by": sb["bound_by"], "library_ms": l_ms,
                       "bound_share": sb["bound_ms"] / k_ms,
                       "us_a_call": 1e3 * k_ms / calls,
                       "plan": plans[key]}
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "cuBLAS bf16 on the weight pre-dequantized to bf16: "
                       "x@W + (x@A)@B^T",
            **b, "calls": len(sets), "tflops": flops / ms / 1e9,
            "bound_share": b["bound_ms"] / ms, "hi_lo_extra_flops": lora_flops,
            "plans": plans, "by_shape": shapes}



LORA_ROUTE_ROWS = (4, 16, 64, 128, 256, 512, 1024)


def time_lora_routes(torch, dev, layers: int = 28) -> dict:
    """The two routes ``linear_apply`` can take on the kernel path for a
    packed-INT linear with LoRA, each timed over the 7 linears x ``layers``
    (bf16, 4-bit, group 64, rank 64, each on its own weights) at each row
    count of ``LORA_ROUTE_ROWS``: the fused kernel, and ``dequant_matmul``
    plus the unfused LoRA term ``(x@A)@B^T``.  ``ops.FUSED_LORA_MIN_ROWS``
    is set from this; ``agrees`` says whether it splits these row counts
    where the faster route changes.  On an H100 80GB HBM3 at 700 W the
    fused kernel is the faster route from 64 rows, the unfused one at 16
    rows and below."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_cuda,
                                                    dequant_matmul_lora_cuda)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    bits, g, r = 4, 64, 64
    bf = torch.bfloat16
    sets = []
    for _ in range(layers):
        for K, N in QWEN_LINEARS:
            packed = torch.randint(0, 256, (K // 2, N), generator=gen,
                                   device=dev, dtype=torch.uint8)
            s = torch.rand((K // g, N), generator=gen, device=dev) * 1e-2
            z = torch.randint(0, 16, (K // g, N), generator=gen,
                              device=dev).float()
            a = (torch.randn((K, r), generator=gen, device=dev)
                 / K ** 0.5).to(bf)
            b = (torch.randn((N, r), generator=gen, device=dev) * 0.1).to(bf)
            sets.append((packed, s, z, a, b))
    rows = {}
    for M in LORA_ROUTE_ROWS:
        xs = {K: torch.randn((M, K), generator=gen, device=dev).to(bf)
              for K in {K for K, _ in QWEN_LINEARS}}

        def fused():
            for p, s, z, a, b in sets:
                x = xs[p.shape[0] * 2]
                dequant_matmul_lora_cuda(x, p, s, z, a, b, bits=bits,
                                         group_size=g)

        def unfused():
            for p, s, z, a, b in sets:
                x = xs[p.shape[0] * 2]
                y = dequant_matmul_cuda(x, p, s, z, bits=bits, group_size=g)
                y + (x @ a) @ b.T

        reps = 5 if M >= 256 else 20
        rows[M] = {"fused_ms": time_graph(torch, fused, reps=reps),
                   "unfused_ms": time_graph(torch, unfused, reps=reps)}
        del xs
    cut = ops.FUSED_LORA_MIN_ROWS
    agrees = all((v["fused_ms"] < v["unfused_ms"]) == (M >= cut)
                 for M, v in rows.items())
    return {"min_rows": cut, "agrees": agrees, "calls": len(sets),
            "rows": {str(M): v for M, v in rows.items()}}


# ---------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------


def parity(torch, dev) -> dict:
    """Smoke model quantized on the card, decoded twice from the same
    params and inputs: through the kernels and through the plain path."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import (decode_step,
                                                init_decode_cache)
    args = serve.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--device", str(dev)])
    cfg = get_smoke_config("qwen3-1.7b")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=0, device=dev)
    cfg, params = serve.build_quantized(args, cfg, params)
    runs = {}
    for use_kernel in (True, False):
        c = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, use_kernel=use_kernel))
        cache = init_decode_cache(c, 4, 32, device=dev)
        tok = torch.tensor([[3], [17], [101], [400]], device=dev)
        out = []
        for _ in range(8):
            logits, cache = decode_step(params, c, cache, tok)
            out.append(logits)
            tok = logits.argmax(-1, keepdim=True)
        runs[use_kernel] = torch.stack(out)
    ok, err = within(runs[True], runs[False], (1e-3, 1e-3))
    same = bool((runs[True].argmax(-1) == runs[False].argmax(-1)).all())
    if not (ok and same):
        raise Failed(f"kernel vs plain decode: max logit err {err}, tokens "
                     f"equal {same}")
    return {"steps": 8, "max_logit_err": err, "tokens_equal": same}


def train_parity(torch, dev) -> dict:
    """The smoke model (f32) quantized on the card takes 3 LoRA steps twice
    from the same params and batches: calibration and training through the
    kernels (``use_kernel``: ``gram`` in calibration, the fused
    ``dequant_matmul_lora`` for the batch's 512 rows) and
    through the plain path.  Losses agree within rtol 1e-4 and gradient
    norms within 1e-3 (f32 sums in another order, through AdamW updates
    that amplify noise-level gradient signs).  Then the fused op's backward
    at a training shape (M = 1024, K = N = 2048, r = 64, bf16) against
    autograd through the plain version, within the bf16 tolerance 2e-2."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_state, make_train_step
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import OptConfig
    cfg = get_smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    calib = [TokenStream(dcfg).next_batch() for _ in range(2)]
    recipe = QuantRecipe.single("cloq", QSpec(bits=4, group_size=16, rank=8))
    ops.reset_launch_counts()
    qparams, qcfg, _ = quantize_model(params, cfg, calib, recipe=recipe)
    grams = ops.launch_counts()["gram"]
    ocfg = OptConfig(lr=1e-3, total_steps=3)
    runs = {}
    for kernels in (True, False):
        c = dataclasses.replace(qcfg, quant=dataclasses.replace(
            qcfg.quant, use_kernel=kernels))
        state = build_state(qparams, ocfg)
        step = make_train_step(c, ocfg)
        stream = TokenStream(dataclasses.replace(dcfg, seed=1))
        ops.reset_launch_counts()
        losses, gnorms = [], []
        for _ in range(3):
            state, m = step(state, stream.next_batch())
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        runs[kernels] = (losses, gnorms, ops.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = runs[True], runs[False]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    gn_err = max(abs(a - b) / abs(b) for a, b in zip(gk, gp))
    if grams <= 0 or ck["dequant_matmul_lora"] != 3 * fused_a_step(qcfg) or \
            cp["dequant_matmul_lora"] or loss_err > 1e-4 or gn_err > 1e-3:
        raise Failed(f"train parity: kernel losses {lk} plain {lp}, grad "
                     f"norms {gk} / {gp}, gram launches {grams}, fused "
                     f"launches {ck} / {cp}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bf = torch.bfloat16
    x, packed, s, z, a, b = _lora_operands(torch, TRAIN_TOKENS, 2048, 2048,
                                           4, 64, 64, bf, dev, gen)
    g = torch.randn((TRAIN_TOKENS, 2048), generator=gen, device=dev).to(bf)
    grads = []
    for fn in (ops.dequant_matmul_lora, ref.dequant_matmul_lora_ref):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        y = fn(xs, packed, s, z, as_, bs, bits=4, group_size=64)
        grads.append(torch.autograd.grad(y, (xs, as_, bs), g))
    torch.cuda.synchronize()
    grad_err = {}
    for name, got, want in zip(("dx", "dA", "dB"), *grads):
        ok, err = within(got, want, TOL["bfloat16"])
        grad_err[name] = err
        if not ok:
            raise Failed(f"fused backward {name}: max err {err}")
    return {"steps": 3, "losses_kernel": lk, "losses_plain": lp,
            "loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
            "calib_gram_launches": grams,
            "fused_launches": ck["dequant_matmul_lora"],
            "backward_max_abs_err": grad_err}


# ---------------------------------------------------------------------------
# quantization engine phases (full width, ENGINE_LAYERS deep)
# ---------------------------------------------------------------------------

ENGINE_LAYERS = 1      # Qwen3-1.7B's 28 cut (the script's time)
# slices a chunk in the engines phase's chunked run: one, so that each of
# the 1-layer model's buckets (2, 2, 2 and 1 slices) runs in as many chunks
ENGINE_CHUNK = 1
ENGINE_TARGET = "blocks.0.attn.q"     # the site the health phase corrupts
# the reference's batched-vs-sequential oracle (tests/test_batched.py)
FLIP_BUDGET = 0.005
REL_FRO = 1e-3
# on the card a one-ulp change of every Gram entry flips up to 5% of a
# site's codes in the sequential engine itself (OPTQ's error feedback
# carries a near-tie flip down its column; PERF.md section 6), so the
# engines' codes are held to twice that, site by site
NUDGE_FACTOR = 2.0
# the train phase's losses as recorded in PERF.md (ROADMAP section 3): a
# wrong base moves them by far more than 1e-2; summation orders by under
# ~2e-3
REF_LOSSES = (12.411189, 11.932083, 11.835666, 11.706970)
LOSS_LIMIT = 1e-2
BASELINES = ("gptq", "loftq", "qlora", "rtn")
# the buckets whose quantize time quantize_split splits, half of the
# full-depth ones (56 and 28 sites; cut for the script's time: every
# operation is batched over the sites, so the split's shares hold):
# name -> (sites L, in-features m, out-features n)
SPLIT_BUCKETS = {"gate_up": (28, 2048, 6144), "down": (14, 6144, 2048)}


def _engine_model(torch, dev):
    """Qwen3-1.7B at full width, ENGINE_LAYERS deep, f32 (the engines'
    f32 factors reach the leaves uncast), random weights from seed 0;
    calibration 2 x 8 x 128 tokens; CLoQ 4-bit, group 64, rank 64."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    cfg = get_config("qwen3-1.7b", n_layers=ENGINE_LAYERS,
                     dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                    global_batch=8, seed=0))
    calib = [stream.next_batch() for _ in range(2)]
    recipe = QuantRecipe.single("cloq", QSpec(bits=4, group_size=64,
                                              rank=64))
    return cfg, params, calib, recipe


def _quantize_eager(torch, dev, model, **kw):
    """``quantize_model`` on the engine model: (eager flat leaves, store,
    report, seconds, peak GB, progress lines)."""
    from repro_torch.core.health import HealthReport
    from repro_torch.core.pipeline import quantize_model, to_eager_params
    from repro_torch.utils import tree_paths
    cfg, params, calib, recipe = model
    report = kw.pop("report", None) or HealthReport()
    msgs: list[str] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    qp, qcfg, store = quantize_model(params, cfg, calib, recipe=recipe,
                                     report=report, progress=msgs.append,
                                     **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (tree_paths(to_eager_params(qp, qcfg)), store, report, dt,
            torch.cuda.max_memory_allocated(dev) / 1e9, msgs)


def _quantize_chunked(torch, dev, model, chunk: int, **kw):
    """``_quantize_eager`` through the batched engine with every bucket
    run in chunks of ``chunk`` slices (``quantize_layer_batch``'s
    ``chunk``, which the pipeline does not expose)."""
    import functools
    from repro_torch.core import pipeline
    real = pipeline.quantize_layer_batch
    pipeline.quantize_layer_batch = functools.partial(real, chunk=chunk)
    try:
        return _quantize_eager(torch, dev, model, engine="batched", **kw)
    finally:
        pipeline.quantize_layer_batch = real


def _bucket_chunks(lines: list) -> list:
    """[slices, chunks, slices a chunk] of each ``[bucket]`` line."""
    out = []
    for ln in lines:
        if ln.startswith("[bucket]") and "chunks=" in ln:
            f = dict(kv.split("=", 1) for kv in ln.split()[1:] if "=" in kv)
            out.append([int(f["layers"]), int(f["chunks"]),
                        int(f["chunk"])])
    return out


def _rel(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))


def _site_recon(torch, leaves: dict, m: int):
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    codes = unpack_codes(leaves["qcodes"], 4, m)
    return codes, dequantize_int(codes, leaves["scales"], leaves["zeros"],
                                 64) + leaves["lora_a"] @ leaves["lora_b"].T


def _site_diff(torch, got: dict, want: dict, W, H) -> dict:
    """One site's leaves against another run's, in the terms of the
    reference's batched-vs-sequential oracle."""
    from repro_torch.core.optq import gram_error
    m = W.shape[0]
    cg, rg = _site_recon(torch, got, m)
    cw, rw = _site_recon(torch, want, m)
    ge_g, ge_w = gram_error(H, W - rg), gram_error(H, W - rw)
    return {"code_flips": float((cg != cw).float().mean()),
            "scales": _rel(torch, got["scales"], want["scales"]),
            "zeros": _rel(torch, got["zeros"], want["zeros"]),
            "lora_ab": _rel(torch, got["lora_a"] @ got["lora_b"].T,
                            want["lora_a"] @ want["lora_b"].T),
            "gram_error": abs(ge_g - ge_w) / max(ge_w, 1e-6)}


def engines_phase(torch, dev) -> tuple[dict, dict]:
    """The engine model quantized by the sequential and then the batched
    engine, each site compared in the terms of the reference's
    batched-vs-sequential oracle (code flip fraction, relative Frobenius
    error of scales, zeros and ``A @ B^T``, relative error of the
    calibrated objective ``gram_error``), beside the same comparison of
    the sequential engine against itself with every Gram entry moved by
    one ulp (``nudge``: how far summation order alone can move a site).
    Held: the objective, scales and zeros within 1e-3; on each site, code
    flips within the flip budget or twice the nudge's flips there,
    whichever is larger; 4 buckets; both runs clean under the health
    guards.  Then ``chunked``: the batched engine once more with every
    bucket cut into chunks of ``ENGINE_CHUNK`` slices (2 L chunks for the
    q/o, k/v and gate/up buckets, L for down), held to the same limits against the sequential engine, with
    whether its bits equal the one-call batched run's."""
    from repro_torch.core.batched import task_key
    from repro_torch.core.pipeline import (_quantize_one,
                                           quantizable_linear_paths,
                                           to_eager_params)
    from repro_torch.utils import get_path
    model = _engine_model(torch, dev)
    cfg, params, recipe = model[0], model[1], model[3]
    eparams = to_eager_params(params, cfg)
    runs = {e: _quantize_eager(torch, dev, model, engine=e)
            for e in ("sequential", "batched")}
    runs["chunked"] = _quantize_chunked(torch, dev, model, ENGINE_CHUNK)
    flat_s, store = runs["sequential"][0], runs["sequential"][1]
    flat_b, flat_c = runs["batched"][0], runs["chunked"][0]
    keys = ("qcodes", "scales", "zeros", "lora_a", "lora_b")
    sites = quantizable_linear_paths(eparams)
    per_site, worst = {}, {"batched": {}, "chunked": {}, "nudge": {}}
    with torch.no_grad():
        for i, site in enumerate(sites):
            W = get_path(eparams, site)["w"].float()
            H = store.grams[site]
            ls = {k: flat_s[f"{site}.{k}"] for k in keys}
            nudged = _quantize_one(
                W, torch.nextafter(H, torch.full_like(H, float("inf"))),
                recipe.qspec, "cloq", task_key(0, i))
            per_site[site] = {
                "batched": _site_diff(torch, {k: flat_b[f"{site}.{k}"]
                                              for k in keys}, ls, W, H),
                "chunked": _site_diff(torch, {k: flat_c[f"{site}.{k}"]
                                              for k in keys}, ls, W, H),
                "nudge": _site_diff(torch, nudged, ls, W, H)}
            for pair, d in per_site[site].items():
                for k, v in d.items():
                    worst[pair][k] = max(worst[pair].get(k, 0.0), v)
    out = {"layers": ENGINE_LAYERS, "sites": len(sites),
           "buckets": sum(1 for ln in runs["batched"][5]
                          if ln.startswith("[bucket]")),
           "bucket_lines": runs["batched"][5],
           "quantize_s": {e: r[3] for e, r in runs.items()},
           "peak_mem_gb": {e: r[4] for e, r in runs.items()},
           "health": {e: r[2].counts() for e, r in runs.items()},
           "checked": {e: r[2].checked for e, r in runs.items()},
           "worst": worst, "per_site": per_site,
           "limits": {"code_flips": FLIP_BUDGET, "rel": REL_FRO},
           "chunked": {"chunk": ENGINE_CHUNK,
                       "buckets": _bucket_chunks(runs["chunked"][5]),
                       "same_bits_as_batched":
                           not _same_leaves(torch, flat_c, flat_b)}}
    # codes: the reference's flip budget, or what one ulp of the Gram does
    # to the sequential engine on the same site (NUDGE_FACTOR x), whichever
    # is larger; A @ B^T is reported, not held: one ulp moves it ~50%
    out["code_flip_limit"] = {
        site: max(FLIP_BUDGET, NUDGE_FACTOR * d["nudge"]["code_flips"])
        for site, d in per_site.items()}
    flips = [(run, site) for site, d in per_site.items()
             for run in ("batched", "chunked")
             if d[run]["code_flips"] > out["code_flip_limit"][site]]
    held = ("scales", "zeros", "gram_error")
    if flips or any(worst[run][k] > REL_FRO for k in held
                    for run in ("batched", "chunked")) or \
            out["buckets"] != 4 or any(out["health"].values()) or \
            out["checked"] != dict.fromkeys(runs, 7 * ENGINE_LAYERS) or \
            sorted(out["chunked"]["buckets"]) != sorted(
                [[ENGINE_LAYERS] * 2 + [1]] + [[2 * ENGINE_LAYERS] * 2
                                               + [1]] * 3):
        raise Failed(f"engines disagree or are unhealthy (code flips past "
                     f"the limit at {flips}): {out}")
    return out, {"model": model, "clean": flat_b, "store": store,
                 "per_site": per_site,
                 "quantize_s": runs["batched"][3]}


def _assert_finite_leaves(torch, flat: dict, what: str) -> None:
    for p, v in flat.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise Failed(f"{what}: non-finite leaf {p}")


def _same_leaves(torch, got: dict, want: dict, skip: str | None = None):
    """Paths whose leaves differ in any bit (``skip``'s prefix left out)."""
    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    return [p for p in want if not (skip and p.startswith(skip + "."))
            and not torch.equal(got[p], want[p])]


def health_phase(torch, dev, eng: dict) -> dict:
    """The batched engine under ``gram_nan`` at the site ENGINE_TARGET:
    every leaf finite, that site healed by the identity Gram with an
    accepted ladder, every other leaf bit-identical to the engines phase's
    clean batched run."""
    from repro_torch.core import faults
    with faults.inject("gram_nan", match=ENGINE_TARGET):
        flat, _, report, dt, peak, _ = _quantize_eager(torch, dev,
                                                       eng["model"])
    _assert_finite_leaves(torch, flat, "health")
    rec = report.records.get(ENGINE_TARGET)
    moved = _same_leaves(torch, flat, eng["clean"], skip=ENGINE_TARGET)
    out = {"fault": "gram_nan", "site": ENGINE_TARGET, "quantize_s": dt,
           "peak_mem_gb": peak, "counts": report.counts(), "record": rec,
           "other_leaves_moved": moved,
           "site_leaves_moved": [p for p in flat if p.startswith(
               ENGINE_TARGET + ".") and not torch.equal(
               flat[p], eng["clean"][p])]}
    if rec is None or rec["status"] != "recovered_identity_gram" or \
            not rec["ladder"] or not rec["ladder"][-1]["accepted"] or \
            report.counts() != {"recovered_identity_gram": 1} or moved:
        raise Failed(f"health phase: {out}")
    return out


def journal_phase(torch, dev, eng: dict) -> dict:
    """A journaled batched run stopped after bucket 0, then rerun: the
    stop raises ``QuantPreempted``, the rerun restores bucket 0 from the
    journal (``journal.restored_buckets`` counts 1), and its leaves are
    bit-identical to the engines phase's uninterrupted run."""
    import shutil
    from repro_torch.core.health import QuantPreempted
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import names as obs_names
    jd = ROOT / "build" / "chip_smoke" / "journal"
    shutil.rmtree(jd, ignore_errors=True)
    try:
        _quantize_eager(torch, dev, eng["model"], journal_dir=str(jd),
                        should_stop=lambda: True)
        raise Failed("journal: should_stop did not preempt the run")
    except QuantPreempted as e:
        stopped_after = e.bucket
    restored = obs_metrics.counter(obs_names.JOURNAL_RESTORED)
    before = restored.value
    flat, _, report, dt, peak, msgs = _quantize_eager(
        torch, dev, eng["model"], journal_dir=str(jd))
    moved = _same_leaves(torch, flat, eng["clean"])
    out = {"stopped_after_bucket": stopped_after,
           "restored_buckets": restored.value - before,
           "events": report.events, "rerun_s": dt, "peak_mem_gb": peak,
           "health_json": (jd / "health.json").is_file(),
           "leaves_moved": moved, "bucket_lines": msgs}
    if stopped_after != 0 or out["restored_buckets"] != 1 or moved or \
            not out["health_json"]:
        raise Failed(f"journal phase: {out}")
    return out


def quantize_split(torch, dev) -> dict:
    """Where a bucket's quantize time goes: the CLoQ stack of
    ``batched.run_bucket`` on ``SPLIT_BUCKETS``, half of Qwen3-1.7B's
    full-depth gate+up bucket (56 x 2048 x 6144) and down bucket (28 x
    6144 x 2048), with random weights and
    Grams of 4096 random tokens, split into MagR, the OPTQ sweep, and the
    Gram root's ``eigh`` with the residual's ``svd``, each timed with CUDA
    events (and on the host clock) in one pass."""
    from repro_torch.core import linalg
    from repro_torch.core.batched import make_spec, spec_qcfg
    from repro_torch.core.cloq import gram_root, regularize_gram
    from repro_torch.core.magr import magr_alpha, magr_preprocess
    from repro_torch.core.optq import optq_quantize_core
    from repro_torch.models.modules import QSpec
    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for name, (L, m, n) in SPLIT_BUCKETS.items():
        spec = make_spec(m, n, QSpec(bits=4, group_size=64, rank=64),
                         "cloq", True)
        Ws = torch.randn((L, m, n), generator=gen, device=dev) * 0.02
        Hs = torch.empty((L, m, m), device=dev)
        for i in range(L):
            X = torch.randn((4096, m), generator=gen, device=dev)
            torch.matmul(X.T, X, out=Hs[i])
        del X
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = [time.perf_counter()]
        ev[0].record()
        Wp = magr_preprocess(Ws, Hs, alpha=magr_alpha(Hs, m),
                             iters=spec.magr_iters)
        ev[1].record()
        host.append(time.perf_counter())
        Qd, Qc, s, z = optq_quantize_core(Wp, Hs, spec_qcfg(spec))
        ev[2].record()
        host.append(time.perf_counter())
        del Wp
        R, Rinv = gram_root(regularize_gram(Hs, spec.lambda_frac))
        U, S, Vh = linalg.svd(R @ (Ws - Qd))
        A = (Rinv @ U[..., :64]) * S[..., None, :64]
        ev[3].record()
        torch.cuda.synchronize()
        host.append(time.perf_counter())
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        out[name] = {"L": L, "m": m, "n": n,
                     "magr_ms": ms[0], "optq_sweep_ms": ms[1],
                     "eigh_svd_ms": ms[2],
                     "host_s": [host[i + 1] - host[i] for i in range(3)],
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 1e9,
                     "finite": bool(torch.isfinite(A).all()) and
                     bool(torch.isfinite(Qd).all())}
        del Ws, Hs, Qd, Qc, s, z, R, Rinv, U, S, Vh, A
        torch.cuda.empty_cache()
        if not out[name]["finite"]:
            raise Failed(f"quantize split: non-finite factors: {out}")
    return out


# (m, n) of the slices whose working set slice_factors measures:
# Qwen3-1.7B's gate/up and down, OLMoE-1B-7B's attention and expert slices
SLICE_SHAPES = ((2048, 6144), (6144, 2048), (2048, 2048), (2048, 1024),
                (1024, 2048))


def slice_factors(torch, dev, L: int = 4) -> dict:
    """The batched engine's working set a slice, the data behind
    ``batched.SLICE_WORK_FACTOR``: ``run_bucket`` (CLoQ 4-bit g64 r64) on
    ``L`` random slices of each of SLICE_SHAPES (Grams of 4096 random
    tokens), its peak memory above what was allocated before the stack
    was staged, over ``L`` x the slice's f32 W and H bytes.  Held: no
    shape's factor above ``SLICE_WORK_FACTOR``."""
    from repro_torch.core.batched import (SLICE_WORK_FACTOR, make_spec,
                                          run_bucket, slice_bytes, task_key)
    from repro_torch.models.modules import QSpec
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    out = {}
    for m, n in SLICE_SHAPES:
        spec = make_spec(m, n, QSpec(bits=4, group_size=64, rank=64),
                         "cloq", True)
        Ws = torch.randn((L, m, n), generator=gen, device=dev) * 0.02
        Hs = torch.empty((L, m, m), device=dev)
        for i in range(L):
            X = torch.randn((4096, m), generator=gen, device=dev)
            torch.matmul(X.T, X, out=Hs[i])
        del X
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev) - L * slice_bytes(spec)
        torch.cuda.reset_peak_memory_stats(dev)
        res = run_bucket(Ws, Hs, [task_key(0, i) for i in range(L)], spec)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        out[f"{m}x{n}"] = (peak - base) / (L * slice_bytes(spec))
        del Ws, Hs, res
        torch.cuda.empty_cache()
    line = {"L": L, "factor": out, "max": max(out.values()),
            "SLICE_WORK_FACTOR": SLICE_WORK_FACTOR}
    if line["max"] > SLICE_WORK_FACTOR:
        raise Failed(f"a slice's working set exceeds SLICE_WORK_FACTOR: "
                     f"{line}")
    return line


def methods_phase(torch, dev, steps: int = 2) -> dict:
    """``repro_torch.launch.train`` for each baseline at full width and
    ENGINE_LAYERS deep (4-bit, group 64, rank 64; qlora NF4 group 64),
    calibration 2 x 8 x 128, 2 steps at 8 x 128: finite losses, ``gram``
    launches 7 a layer a calibration batch for every method,
    ``dequant_matmul_lora`` 7 a layer a step for the INT methods and 0
    for qlora, ``B == 0`` at init for gptq, qlora and rtn."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils import tree_paths
    real = train.quantize_model
    out = {}
    for method in BASELINES:
        argv = ["--arch", "qwen3-1.7b", "--method", method, "--bits", "4",
                "--group-size", "64", "--rank", "64", "--calib-batches",
                "2", "--batch", "8", "--seq-len", "128", "--steps",
                str(steps), "--seed", "0", "--device", str(dev)]
        args = train.build_parser().parse_args(argv)
        cfg = get_config("qwen3-1.7b", n_layers=ENGINE_LAYERS)
        init: dict = {}

        def spy(*a, **kw):
            res = real(*a, **kw)
            init.update(b_max=max(float(v.abs().max())
                                  for p, v in tree_paths(res[0]).items()
                                  if p.endswith("lora_b")),
                        absmax=any(p.endswith("absmax")
                                   for p in tree_paths(res[0])))
            return res

        train.quantize_model = spy
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            res = train.run(args, cfg)
            counts = ops.launch_counts()
        finally:
            train.quantize_model = real
        L = ENGINE_LAYERS
        want = {"gram": 7 * L * args.calib_batches,
                "dequant_matmul_lora": 0 if method == "qlora"
                else fused_a_step(cfg) * steps}
        line = {"quantize_s": res["quantize_s"], "losses": res["losses"],
                "grad_norms": res["grad_norms"], "step_s": res["step_s"],
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches": counts, "launches_expected": want,
                "init_lora_b_max_abs": init.get("b_max"),
                "nf4": init.get("absmax"),
                "health": res["health"].counts()}
        out[method] = line
        if any(counts[k] != v for k, v in want.items()) or \
                not all(map(math.isfinite, res["losses"])) or \
                len(res["losses"]) != steps or line["health"] or \
                (method != "loftq") != (init.get("b_max") == 0.0) or \
                (method == "qlora") != init.get("absmax"):
            raise Failed(f"methods phase, {method}: {line}")
        del res
    return out


def train_phase(torch, dev, steps: int = 4):
    """``repro_torch.launch.train`` at full width and depth.  Returns the
    phase line, the run's result and its parsed arguments."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils import tree_paths
    import shutil
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    argv = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
            "--group-size", "64", "--rank", "64", "--calib-batches", "4",
            "--batch", "8", "--seq-len", "128", "--steps", str(steps),
            "--seed", "0", "--device", str(dev),
            "--ckpt-dir", str(CKPT_DIR)]
    args = train.build_parser().parse_args(argv)
    cfg = get_config("qwen3-1.7b")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = train.run(args, cfg)
    counts = ops.launch_counts()
    L = cfg.n_layers
    step_s = res["step_s"]
    tokens = args.batch * args.seq_len
    n_lora = sum(1 for p, v in tree_paths(res["state"]["train"]).items()
                 if p.endswith("lora_a") and v.numel())
    out = {"layers": L, "argv": argv, "quantize_s": res["quantize_s"],
           "step_s": step_s, "tokens_per_step": tokens,
           "train_tok_s": tokens * len(step_s) / sum(step_s),
           "train_tok_s_after_first": tokens * (len(step_s) - 1)
           / sum(step_s[1:]),
           "losses": res["losses"], "grad_norms": res["grad_norms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": counts, "lora_sites": n_lora,
           "loss_rel_diff_vs_ref": max(
               abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   REF_LOSSES)),
           "health": res["health"].counts(),
           "health_checked": res["health"].checked,
           "ckpt_dir": str(CKPT_DIR.relative_to(ROOT)),
           "ckpt_step": res["ckpt_step"],
           "ckpt_gb": sum(f.stat().st_size for f in CKPT_DIR.rglob("*")
                          if f.is_file()) / 1e9}
    if res["ckpt_step"] != steps:
        raise Failed(f"train saved step {res['ckpt_step']}, not {steps}")
    want = {"gram": 7 * L * args.calib_batches,
            "dequant_matmul_lora": fused_a_step(cfg) * steps}
    if any(counts[k] != v for k, v in want.items()):
        raise Failed(f"train path launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in res["losses"] + res["grad_norms"]):
        raise Failed(f"train losses not finite: {out}")
    if n_lora != 7:
        raise Failed(f"train state holds {n_lora} stacked LoRA sites, not 7")
    if out["loss_rel_diff_vs_ref"] > LOSS_LIMIT:
        raise Failed(f"train losses {res['losses']} are more than "
                     f"{LOSS_LIMIT} off the recorded {REF_LOSSES}")
    if out["health"] or out["health_checked"] != 7 * L:
        raise Failed(f"a clean run reported fallbacks: {out['health']}, "
                     f"{out['health_checked']} slices checked")
    return out, res, args


# the kernels the serve path runs: its quantized linears carry LoRA, but
# decode's 4 rows are below ops.FUSED_LORA_MIN_ROWS, so LoRA is added
# unfused; its calibration runs through gram
SERVE_KERNELS = ("dequant_matmul", "flash_attention", "gram")
SERVE_RANKS = (64, 16)


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _engine_step_ms(s: dict) -> dict:
    """Median host ms of the engine's steps, by bucket decodes a step."""
    by: dict = {}
    for t, n in zip(s["step_s"], s["step_decodes"]):
        by.setdefault(n, []).append(t)
    return {n: 1e3 * _median(ts) for n, ts in sorted(by.items())}


def serve_phase(torch, dev, layers: int) -> tuple[dict, dict]:
    """The serve CLI's engine route at full width (see the module doc)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.utils import assert_finite, tree_paths, tree_size_bytes
    tuned = layers == 28
    argv = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
            "--batch", "4", "--requests", "8", "--max-new", "16",
            "--cache-len", "128", "--page-size", "8", "--tenants", "4",
            "--ranks", ",".join(map(str, SERVE_RANKS)), "--seed", "0",
            "--device", str(dev)]
    if tuned:
        argv += ["--adapter", f"tuned={CKPT_DIR}"]
    args = serve.build_parser().parse_args(argv)
    cfg = get_config("qwen3-1.7b", n_layers=layers)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.run(args, cfg)
    counts = ops.launch_counts()
    s = res["serve"]
    try:
        assert_finite(res["params"], "quantized params")
        bad = []
    except FloatingPointError as e:
        bad = [str(e)]
    n_quant = sum(1 for p in tree_paths(res["params"]) if
                  p.endswith(".qcodes"))
    eng = res["engine"]
    decodes = sum(s["decodes"].values())
    captured = {r: {"calls": c.calls, "eager_warmup": c.warmup,
                    "replays": c.calls - c.warmup,
                    "launches_a_replay": c.launches}
                for r, c in eng._captured.items()}
    served = {}
    for t, o in zip(s["tenant_of"], s["outputs"]):
        served.setdefault(t, []).append(len(o))
    out = {"layers": layers, "argv": argv, "route": res["route"],
           "quantize_s": res["quantize_s"], "decode_s": s["seconds"],
           "engine_steps": s["steps"], "decodes": s["decodes"],
           "tokens": s["tokens"], "tok_s": s["tok_s"],
           "slot_tokens": s["slot_tokens"], "slot_tok_s": s["slot_tok_s"],
           "step_ms_median": 1e3 * _median(s["step_s"]),
           "step_ms_median_by_decodes": _engine_step_ms(s),
           "step_ms_first": 1e3 * s["step_s"][0],
           "p50_request_ms": s["p50_ms"], "requests_done": s["requests_done"],
           "tenants": res["tenants"], "rank_buckets": s["rank_buckets"],
           "tokens_by_tenant": served, "captured": captured,
           "quantized_linears": n_quant,
           "param_gb": tree_size_bytes(res["params"]) / 1e9,
           "adapter_gb": sum(tree_size_bytes(res["registry"].stacks(r))
                             for r in res["registry"].ranks()) / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": counts, "nonfinite": bad}
    per = {"dequant_matmul": 7 * layers, "flash_attention": layers}
    want = {k: v * decodes for k, v in per.items()}
    if res["route"] != "engine" or any(counts[k] != v
                                       for k, v in want.items()) or \
            min(counts[k] for k in SERVE_KERNELS) <= 0:
        raise Failed(f"serve path launches {counts}, expected {want} over "
                     f"{decodes} bucket decodes ({res['route']} route)")
    # each bucket's first decode runs eagerly, each later one replays its
    # graph, which counts the launches captured in it
    replayed = {k: sum(c["replays"] * c["launches_a_replay"][k]
                       for c in captured.values()) for k in per}
    eager = {k: sum(c["eager_warmup"] for c in captured.values()) * v
             for k, v in per.items()}
    out["launches_replayed"] = replayed
    if set(captured) != set(SERVE_RANKS) or any(
            c["launches_a_replay"][k] != v for c in captured.values()
            for k, v in per.items()) or any(
            replayed[k] + eager[k] != want[k] for k in want):
        raise Failed(f"replays do not account for the launches: captured "
                     f"{captured}, replayed {replayed}, want {want}")
    if set(s["decodes"]) != set(SERVE_RANKS):
        raise Failed(f"not every rank bucket decoded: {s['decodes']}")
    if s["requests_done"] != 8 or s["requests"] != 8 or \
            s["tokens"] != 8 * 16 or any(n != 16 for v in served.values()
                                         for n in v):
        raise Failed(f"serve.* counters / tokens wrong: {out}")
    if tuned and (res["tenants"][-1] != "tuned" or not served.get("tuned")):
        raise Failed(f"the loaded tenant was not served: {served}")
    if bad or n_quant != 7:
        raise Failed(f"serve output wrong: {out}")
    return out, res


def serve_graph(torch, dev, res) -> dict:
    """Captured against eager decode on the served params: the engine (8
    requests x 16 tokens over the serve phase's tenants) and the
    fixed-slot loop (batch 4, 8 requests x 16 tokens, cache 128), each
    run eagerly and then captured; greedy tokens equal within each pair.
    Slot tokens/s of each whole run (a captured run includes its
    captures) and of its median step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    params, cfg = res["params"], res["cfg"]
    out, runs = {}, {}
    for graph in (False, True):
        eng = ServeEngine(params, cfg, res["registry"], page_size=8,
                          max_len=128, bucket_capacity=4, use_kernel=True,
                          graph=graph)
        ops.reset_launch_counts()
        s = serve.serve_engine(eng, res["tenants"], requests=8,
                               max_new=16, seed=0)
        name = "engine_" + ("captured" if graph else "eager")
        runs[name] = s["outputs"]
        slots = s["slot_tokens"] / len(s["step_s"])
        out[name] = {"slot_tok_s": s["slot_tok_s"], "tok_s": s["tok_s"],
                     "seconds": s["seconds"], "engine_steps": s["steps"],
                     "decodes": s["decodes"],
                     "step_ms_median": 1e3 * _median(s["step_s"]),
                     "step_ms_median_by_decodes": _engine_step_ms(s),
                     "slot_tok_s_median_step": slots / _median(s["step_s"]),
                     "launches": ops.launch_counts()}
        del eng
    for graph in (False, True):
        ops.reset_launch_counts()
        s = serve.serve_fixed_slots(params, cfg, batch=4, cache_len=128,
                                    requests=8, max_new=16, seed=0,
                                    device=dev, graph=graph)
        name = "fixed_slots_" + ("captured" if graph else "eager")
        runs[name] = [o.tolist() for o in s["outputs"]]
        out[name] = {"slot_tok_s": s["tok_s"], "seconds": s["seconds"],
                     "steps": s["steps"],
                     "step_ms_median": 1e3 * _median(s["step_s"]),
                     "slot_tok_s_median_step": 4 / _median(s["step_s"]),
                     "launches": ops.launch_counts(),
                     "logits_finite": s["all_finite"]}
    torch.cuda.synchronize()
    for loop in ("engine", "fixed_slots"):
        same = runs[f"{loop}_eager"] == runs[f"{loop}_captured"]
        out[f"{loop}_tokens_equal"] = same
        if not same:
            raise Failed(f"{loop}: captured decode's tokens differ from the "
                         f"eager decode's: {runs}")
    want = {"dequant_matmul": 7 * cfg.n_layers * 32,
            "flash_attention": cfg.n_layers * 32}
    for name in ("fixed_slots_eager", "fixed_slots_captured"):
        got = {k: out[name]["launches"][k] for k in want}
        if got != want or not out[name]["logits_finite"]:
            raise Failed(f"{name}: launches {got}, expected {want}")
    return out


def _profiled(torch, run, cpu_events: bool = True
              ) -> tuple[float, float, list]:
    """``run()`` (which returns its own synced wall seconds) under
    ``torch.profiler``: (wall s, device busy s, top device events).
    Device busy time is the sum of the device-side events' (kernels',
    copies') times — one stream at a time, so they do not overlap;
    operator-level events, which also carry the time of the kernels they
    launch, are left out so nothing counts twice.  ``cpu_events=False``
    records the device's events only: the decode profiles run thousands
    of operators a step, and recording and summing them on the host takes
    minutes without changing the device's times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU] if cpu_events else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        wall = run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return wall, busy, [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top]


def _profile_line(steps: int, wall: float, busy: float, top: list) -> dict:
    return {"steps": steps, "wall_s": wall, "step_ms": 1e3 * wall / steps,
            "device_busy_s": busy,
            "device_busy_ms_per_step": 1e3 * busy / steps,
            "device_idle_share": (1 - busy / wall) if busy else None,
            "top_kernels_ms_per_step": [[k, ms / steps, n]
                                        for k, ms, n in top]}


def _decode_profile_line(steps, wall, busy, top, step_s) -> dict:
    line = _profile_line(steps, wall, busy, top)
    med = _median(step_s)
    line.update(step_ms_median=1e3 * med,
                device_idle_share_median_step=(1 - busy / steps / med)
                if busy else None)
    return line


PROFILE_REQUESTS = 4     # cut from 8 (the script's time)
PROFILE_TOKENS = 8       # a request's tokens, cut from 16 (the same)


def profile_decode(torch, dev, res) -> dict:
    """Where a decode step's time goes, under ``torch.profiler``: the
    fixed-slot loop (batch 4, ``PROFILE_REQUESTS`` requests x
    ``PROFILE_TOKENS`` tokens) and the engine (the serve phase's tenants,
    ``PROFILE_REQUESTS`` requests x ``PROFILE_TOKENS`` tokens), each eager
    and
    captured, each after a warm run of the same.  The captured fixed-slot
    run captures inside the window (its first step eager, the capture
    once); the engine's buckets were captured in its warm run."""
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    params, cfg = res["params"], res["cfg"]
    kw = dict(batch=4, cache_len=128, requests=PROFILE_REQUESTS,
              max_new=PROFILE_TOKENS,
              seed=1, device=dev)
    out = {}
    for graph in (False, True):
        serve.serve_fixed_slots(params, cfg, graph=graph, **kw)     # warm
        got = {}

        def run():
            got.update(serve.serve_fixed_slots(params, cfg, graph=graph,
                                               **kw))
            return got["seconds"]

        wall, busy, top = _profiled(torch, run, cpu_events=False)
        out["fixed_slots_" + ("captured" if graph else "eager")] = \
            _decode_profile_line(got["steps"], wall, busy, top,
                                 got["step_s"])
    for graph in (False, True):
        eng = ServeEngine(params, cfg, res["registry"], page_size=8,
                          max_len=128, bucket_capacity=4, use_kernel=True,
                          graph=graph)
        serve.serve_engine(eng, res["tenants"], requests=PROFILE_REQUESTS,
                           max_new=PROFILE_TOKENS, seed=1)           # warm
        got = {}

        def run():
            got.update(serve.serve_engine(eng, res["tenants"],
                                          requests=PROFILE_REQUESTS,
                                          max_new=PROFILE_TOKENS,
                                          seed=1))
            return got["seconds"]

        wall, busy, top = _profiled(torch, run, cpu_events=False)
        line = _decode_profile_line(got["steps"], wall, busy, top,
                                    got["step_s"])
        line["decodes"] = got["decodes"]
        line["step_ms_median_by_decodes"] = _engine_step_ms(got)
        line["device_busy_ms_per_decode"] = 1e3 * busy / sum(
            got["decodes"].values())
        out["engine_" + ("captured" if graph else "eager")] = line
        del eng
    return out


def profile_train(torch, dev, res, args, steps: int = 1) -> dict:
    """Where a train step's time goes: the fine-tuned full-width model
    takes ``steps`` more LoRA steps (after one warm step) under
    ``torch.profiler``, each ended by a device synchronize."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig
    cfg = res["cfg"]
    ocfg = OptConfig(lr=args.lr, trainable="lora", total_steps=args.steps,
                     schedule=args.schedule)
    step = make_train_step(cfg, ocfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                    global_batch=args.batch,
                                    seed=args.seed + 1))
    state = {"s": step(res["state"], stream.next_batch())[0]}     # warm
    batches = [stream.next_batch() for _ in range(steps)]
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        for b in batches:
            state["s"], _ = step(state["s"], b)
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, busy, top = _profiled(torch, run)
    return _profile_line(steps, wall, busy, top)


# ---------------------------------------------------------------------------
# slice 8: the MoE family and the other dense configs at full width
# ---------------------------------------------------------------------------

MOE_LAYERS = 1          # OLMoE-1B-7B's 16 cut so that the script fits
MOE_STEPS = 3
# the kernels the MoE path runs on its attention sites (the expert
# products are plain einsums, as the JAX package's)
MOE_KERNELS = ("gram", "dequant_matmul_lora", "dequant_matmul",
               "flash_attention")
# the dense configs quantized by CLoQ, and Qwen3-30B-A3B by RTN (no Gram
# is read: one card cannot hold its experts' Grams at full depth)
CONFIG_RUNS = (("qwen3-4b", "cloq"), ("codeqwen1.5-7b", "cloq"),
               ("minicpm-2b", "cloq"), ("qwen3-moe-30b-a3b", "rtn"))


def _spied_train(torch, train, args, cfg, inspect=None) -> tuple[dict, dict]:
    """``train.run(args, cfg)`` keeping what ``quantize_model`` returned
    (the quantized params before fine-tuning, their config), its
    ``[bucket]`` lines and ``memory``: the device memory allocated and
    the peak so far (GB) and the seconds since the start at each bucket's
    end and when it returns.
    ``inspect(params, qparams, qcfg, store)``, given, runs on the dense
    params, the quantized ones and the Grams as ``quantize_model``
    returns, its result kept as ``inspected``; the Grams are dropped
    then (the CLI does not keep them either)."""
    real = train.quantize_model
    got: dict = {"lines": [], "memory": []}
    t0 = time.perf_counter()

    def mark(event: str) -> None:
        got["memory"].append([event, torch.cuda.memory_allocated() / 1e9,
                              torch.cuda.max_memory_allocated() / 1e9,
                              time.perf_counter() - t0])

    def progress(line: str) -> None:
        got["lines"].append(line)
        mark(line.split()[1])

    def spy(*a, **kw):
        kw["progress"] = progress
        mark("start")
        res = real(*a, **kw)
        mark("quantized")
        got.update(params=res[0], cfg=res[1])
        if inspect is not None:
            got["inspected"] = inspect(a[0], res[0], res[1], res[2])
        return res[0], res[1], None

    train.quantize_model = spy
    try:
        return train.run(args, cfg), got
    finally:
        train.quantize_model = real


def _plain_losses(torch, dev, args, qparams, qcfg, steps: int) -> list:
    """The train CLI's steps replayed on the same quantized params and
    batches (the stream past its calibration batches, of the model's data
    kind as the CLI draws them) with every kernel off: the plain path's
    losses."""
    import dataclasses
    from repro_torch.data import DataConfig, TokenStream, data_kind
    from repro_torch.launch.steps import build_state, make_train_step
    from repro_torch.optim import OptConfig
    cfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=False))
    ocfg = OptConfig(lr=args.lr, trainable="lora", total_steps=args.steps,
                     schedule=args.schedule)
    stream = TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        seed=args.seed, kind=data_kind(cfg),
        enc_len=max(args.seq_len // 4, 8), n_prefix=cfg.n_prefix,
        d_model=cfg.d_model))
    for _ in range(args.calib_batches):
        stream.next_batch()
    state, step = build_state(qparams, ocfg), make_train_step(cfg, ocfg)
    losses = []
    for _ in range(steps):
        state, m = step(state, stream.next_batch())
        losses.append(float(m["loss"]))
    return losses


def _serve_both(torch, dev, arch, qparams, qcfg, *, ranks, tenants,
                requests, max_new) -> dict:
    """The serve CLI's engine route on ``qparams`` (registry and tenants
    as ``serve.build_registry`` makes them), run eagerly and then with
    each rank bucket's decode captured: tokens, slot tokens/s and the
    launches of each run."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    sargs = serve.build_parser().parse_args(
        ["--arch", arch, "--batch", "4", "--tenants", str(tenants),
         "--ranks", ",".join(map(str, ranks)), "--seed", "0",
         "--device", str(dev)])
    registry, names = serve.build_registry(sargs, qparams)
    cfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    out = {}
    for graph in (False, True):
        eng = ServeEngine(qparams, cfg, registry, page_size=8, max_len=128,
                          bucket_capacity=4, use_kernel=True, graph=graph)
        ops.reset_launch_counts()
        s = serve.serve_engine(eng, names, requests=requests,
                               max_new=max_new, seed=0)
        out["captured" if graph else "eager"] = {
            "outputs": s["outputs"], "slot_tok_s": s["slot_tok_s"],
            "tok_s": s["tok_s"], "seconds": s["seconds"],
            "step_ms_median": 1e3 * _median(s["step_s"]),
            "decodes": s["decodes"], "requests_done": s["requests_done"],
            "launches": ops.launch_counts(),
            "captured": sorted(eng._captured)}
        del eng
    out["tokens_equal"] = out["eager"]["outputs"] == \
        out["captured"]["outputs"]
    return out


def _sites_2d(cfg) -> int:
    """Quantized 2-D linears a layer (the kernels' sites)."""
    return 7 if cfg.family == "dense" else 4


def _gram_sites(cfg) -> int:
    """``gram`` launches a layer a calibration batch."""
    return 7 if cfg.family == "dense" else 4 + 3 * cfg.n_experts


def moe_phase(torch, dev, layers: int) -> dict:
    """OLMoE-1B-7B at full width (d_model 2048, 64 experts top-8, expert
    d_ff 1024, vocab 50304, bf16), ``layers`` deep: the train CLI's path
    (CLoQ 4-bit g64 r64, calibration 2 x 8 x 128 tokens, 3 steps at 8 x
    128), its losses against the plain path's on the same quantized
    params and batches, then the engine route on the quantized params
    (ranks 64 and 16, 4 tenants, 8 one-token requests x 16 tokens) eager
    and captured.  Held: finite losses within 1e-2 of the plain path's,
    an empty health report, captured tokens equal to eager ones, every
    request served, and each kernel's launches (4 attention linears a
    layer; ``gram`` 4 + 3 x 64 a layer a calibration batch)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import moe
    argv = ["--arch", "olmoe-1b-7b", "--method", "cloq", "--bits", "4",
            "--group-size", "64", "--rank", "64", "--calib-batches", "2",
            "--batch", "8", "--seq-len", "128", "--steps", str(MOE_STEPS),
            "--seed", "0", "--device", str(dev)]
    args = train.build_parser().parse_args(argv)
    cfg = get_config("olmoe-1b-7b", n_layers=layers)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with moe.record_drops() as drops:
        res, got = _spied_train(torch, train, args, cfg)
    counts = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    dropped = sum(int(d) for d, _ in drops)
    routed = sum(n for _, n in drops)
    qparams, qcfg = got["params"], got["cfg"]
    plain = _plain_losses(torch, dev, args, qparams, qcfg, MOE_STEPS)
    del res["state"]
    torch.cuda.reset_peak_memory_stats(dev)
    sv = _serve_both(torch, dev, "olmoe-1b-7b", qparams, qcfg,
                     ranks=SERVE_RANKS, tenants=4, requests=8, max_new=16)
    step_s, tokens = res["step_s"], args.batch * args.seq_len
    L = layers
    want_train = {"gram": _gram_sites(cfg) * L * args.calib_batches,
                  "dequant_matmul_lora": fused_a_step(cfg) * MOE_STEPS,
                  "dequant_matmul": 0, "flash_attention": 0}
    cap = sv["captured"]
    decodes = sum(cap["decodes"].values())
    want_serve = {"dequant_matmul": _sites_2d(cfg) * L * decodes,
                  "flash_attention": L * decodes}
    out = {"layers": L, "reduced": {"n_layers": [16, L]}, "argv": argv,
           "quantize_s": res["quantize_s"],
           "buckets": _bucket_chunks(got["lines"]),
           "bucket_lines": got["lines"], "memory_gb": got["memory"],
           "peak_mem_gb": {"train": train_peak,
                           "serve": torch.cuda.max_memory_allocated(dev)
                           / 1e9},
           "losses": res["losses"], "losses_plain": plain,
           "loss_rel_diff_vs_plain": max(abs(a - b) / abs(b) for a, b in
                                         zip(res["losses"], plain)),
           "grad_norms": res["grad_norms"], "step_s": step_s,
           "train_tok_s": tokens * len(step_s) / sum(step_s),
           "captured_tokens_equal": sv["tokens_equal"],
           "launches": {"train": counts, "serve_captured": cap["launches"],
                        "serve_eager": sv["eager"]["launches"]},
           "dropped_share": dropped / max(routed, 1),
           "routed_slots": routed,
           "health": res["health"].counts(),
           "health_events": res["health"].events,
           "health_checked": res["health"].checked}
    out["engine"] = {k: {f: sv[k][f] for f in
                         ("slot_tok_s", "tok_s", "seconds",
                          "step_ms_median", "decodes", "captured")}
                     for k in ("eager", "captured")}
    bad = []
    if not all(math.isfinite(v) for v in res["losses"] + plain):
        bad.append("losses not finite")
    if out["loss_rel_diff_vs_plain"] > LOSS_LIMIT:
        bad.append(f"losses more than {LOSS_LIMIT} off the plain path's")
    if out["health"] or out["health_events"] or \
            out["health_checked"] != L * (4 + 3 * cfg.n_experts):
        bad.append("health report not empty")
    if any(counts[k] != v for k, v in want_train.items()):
        bad.append(f"train launches, expected {want_train}")
    if any(cap["launches"][k] != v for k, v in want_serve.items()) or \
            cap["captured"] != sorted(SERVE_RANKS):
        bad.append(f"serve launches, expected {want_serve}")
    if not sv["tokens_equal"]:
        bad.append("captured tokens differ from eager ones")
    if cap["requests_done"] != 8 or any(len(o) != 16
                                        for o in cap["outputs"]):
        bad.append("not every request served")
    if bad:
        raise Failed(f"moe phase: {bad}: {out}")
    return out


def _kernel_routes(torch, dev, params, cfg, shards: tuple = (1, 1)
                   ) -> dict:
    """The routes the kernels take on one layer of each of ``params``'
    stacks (and on a hybrid's shared block, with site 0's adapters): each
    quantized 2-D linear's decode (4 rows) and fused train (1024 rows)
    route, an enc-dec cross k/v's fused decode route (over all of a
    128-position encoder output at 4 slots) third, the decode attention's
    (where the flash kernel runs it) and each calibration width's
    Gram.  ``shards`` = (data, model): ``params`` are a rank's local
    shards (``parallel.localize``), the rows its data share, the
    attention its heads, and no Gram (calibration runs unsharded)."""
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gram as gm
    from repro_torch.models.transformer import _with_site_lora, layer_params
    from repro_torch.utils import get_path, tree_paths
    lp = {k: {"0": layer_params(params[k], 0)}
          for k in ("blocks", "enc_blocks", "dec_blocks", "cross")
          if k in params}
    if "shared" in params:
        sh = params["shared"]
        lp["shared"] = _with_site_lora(sh["block"], sh["site_lora"], 0)
    bf = torch.bfloat16
    nd, nm = shards
    routes = {}
    for path, leaf in tree_paths(lp).items():
        if not path.endswith(".qcodes") or leaf.dim() != 2:
            continue
        node = get_path(lp, path[:-len(".qcodes")])
        K = node["lora_a"].shape[0]
        g = K // node["scales"].shape[0]
        x4 = torch.zeros((4 // nd, K), dtype=bf, device=dev)
        xt = torch.zeros((TRAIN_TOKENS // nd, K), dtype=bf, device=dev)
        a, b = node["lora_a"].to(bf), node["lora_b"].to(bf)
        routes[path[:-len(".qcodes")]] = [
            dq.plan_for(x4, leaf, node["scales"], node["zeros"], g).route,
            dq.lora_plan_for(xt, leaf, node["scales"], node["zeros"], a, b,
                             g).route]
        if path.endswith(("xattn.k.qcodes", "xattn.v.qcodes")):
            xd = torch.zeros((CROSS_DECODE_ROWS // nd, K), dtype=bf,
                             device=dev)
            routes[path[:-len(".qcodes")]].append(dq.lora_plan_for(
                xd, leaf, node["scales"], node["zeros"], a, b, g).route)
    heads = config_shapes(cfg)["heads"]
    if heads is not None:
        Hq, Hkv, d = heads
        q = torch.zeros((4 // nd, 1, Hq // nm, d), dtype=bf,
                        device=dev).transpose(1, 2)
        kv = torch.zeros((4 // nd, 128, Hkv // nm, d), dtype=bf,
                         device=dev).transpose(1, 2)
        routes["flash_attention"] = fa.plan_for(q, kv, kv).route
    for D in config_shapes(cfg)["grams"] if shards == (1, 1) else ():
        routes[f"gram_{D}"] = gm.plan_for(torch.zeros(
            (TRAIN_TOKENS, D), dtype=bf, device=dev)).route
    return routes


# Kernel against plain decode logits (configs, ssm, allocate).  Each kernel
# call of a decode step may differ from its plain version by the JAX
# package's bf16 kernel tolerance (tests/test_kernels.py:12-14: atol 2e-2,
# rtol 2e-2 of its output's scale); the errors of the n calls a decode
# step makes are independent and add in quadrature through the residual
# stream, so the logits may differ by
#     LOGIT_ATOL + LOGIT_RTOL * sqrt(n) * max |plain logit|
# with n counted (launches a step) and the logits' scale read in the run.
# On an H100 the sound kernels gave 0.035-0.198 against limits of
# 0.25-0.96 (PERF.md, PR 21 run B), and a zero one grid step off on one
# group gave 1.83-6.92 against 0.29-0.30 (chip_fault_check.py).
LOGIT_ATOL = 2e-2
LOGIT_RTOL = 2e-2


def logits_limit(max_abs_logit: float, calls: float) -> float:
    """The limit of kernel against plain decode logits (see above)."""
    return LOGIT_ATOL + LOGIT_RTOL * math.sqrt(calls) * max_abs_logit


def _kernel_vs_plain_logits(torch, dev, params, cfg, steps: int = 4) -> dict:
    """Kernel against plain decode over ``steps`` greedy steps at batch 4
    from the same caches and tokens (an enc-dec model's ``enc_out`` from
    :func:`encoder_output`, so that its cross-attention carries signal):
    the largest |logit| difference, the plain logits' largest |logit|,
    the kernel calls a step (launches counted around the kernel steps),
    :func:`logits_limit` of them and whether the difference is within
    it."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (decode_step,
                                                init_decode_cache)
    cfgs = [dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, use_kernel=k)) for k in (True, False)]
    caches = [init_decode_cache(c, 4, 16, device=dev) for c in cfgs]
    if cfg.family == "encdec":
        enc_out = encoder_output(torch, dev, params, cfg, 16)
        for c in caches:
            c["enc_out"].copy_(enc_out)
    tok = torch.tensor([[3], [17], [101], [400]], device=dev)
    err = scale = 0.0
    calls = 0
    with torch.no_grad():
        for _ in range(steps):
            out = []
            for i, c in enumerate(cfgs):
                before = sum(ops.launch_counts().values())
                logits, caches[i] = decode_step(params, c, caches[i], tok)
                if i == 0:
                    calls += sum(ops.launch_counts().values()) - before
                out.append(logits.float())
            err = max(err, float((out[0] - out[1]).abs().max()))
            scale = max(scale, float(out[1].abs().max()))
            tok = out[0].argmax(-1, keepdim=True)
    limit = logits_limit(scale, calls / steps)
    return {"max_abs_err": err, "max_abs_logit": scale,
            "kernel_calls_per_step": calls / steps, "limit": limit,
            "within": err <= limit}


def configs_phase(torch, dev) -> dict:
    """Each of CONFIG_RUNS at full width, 1 layer: the train CLI's path (4
    bits, group 64, rank 64, calibration 1 x 8 x 128, 2 steps at 8 x 128),
    then its serving route on the quantized params (the engine, 4 tenants
    at rank 64, 4 one-token requests x 8 tokens) eager and captured.  Per
    config: quantize seconds, peak memory, the routes its kernels took,
    the largest difference of kernel against plain decode logits.  Held:
    finite losses, an empty health report, the kernels' launches,
    captured tokens equal to eager ones."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    out = {}
    for arch, method in CONFIG_RUNS:
        argv = ["--arch", arch, "--method", method, "--bits", "4",
                "--group-size", "64", "--rank", "64", "--calib-batches",
                "1", "--batch", "8", "--seq-len", "128", "--steps", "2",
                "--seed", "0", "--device", str(dev)]
        args = train.build_parser().parse_args(argv)
        cfg = get_config(arch, n_layers=1)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res, got = _spied_train(torch, train, args, cfg)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        del res["state"]
        qparams, qcfg = got["params"], got["cfg"]
        sv = _serve_both(torch, dev, arch, qparams, qcfg, ranks=(64,),
                         tenants=4, requests=4, max_new=8)
        cap = sv["captured"]
        decodes = sum(cap["decodes"].values())
        want = {"gram": _gram_sites(cfg) * args.calib_batches,
                "dequant_matmul_lora": fused_a_step(cfg) * 2}
        line = {"layers": 1, "method": method,
                "reduced": {"n_layers": [get_config(arch).n_layers, 1]},
                "quantize_s": res["quantize_s"],
                "buckets": _bucket_chunks(got["lines"]),
                "peak_mem_gb": peak, "losses": res["losses"],
                "step_s": res["step_s"],
                "routes": _kernel_routes(torch, dev, qparams, qcfg),
                "kernel_vs_plain_logits": _kernel_vs_plain_logits(
                    torch, dev, qparams, qcfg),
                "captured_tokens_equal": sv["tokens_equal"],
                "slot_tok_s": {k: sv[k]["slot_tok_s"]
                               for k in ("eager", "captured")},
                "launches": {"train": counts,
                             "serve_captured": cap["launches"]},
                "health": res["health"].counts()}
        out[arch] = line
        if not all(map(math.isfinite, res["losses"])) or line["health"] or \
                res["health"].events or \
                any(counts[k] != v for k, v in want.items()) or \
                cap["launches"]["dequant_matmul"] != \
                _sites_2d(cfg) * decodes or \
                cap["launches"]["flash_attention"] != decodes or \
                not sv["tokens_equal"] or \
                not line["kernel_vs_plain_logits"]["within"] or \
                any(len(o) != 8 for o in cap["outputs"]):
            raise Failed(f"configs phase, {arch} (launches expected "
                         f"{want}): {line}")
        del res, got, qparams, sv
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 9: the SSM and hybrid families at full width
# ---------------------------------------------------------------------------

HYBRID_LAYERS = 12      # Zamba2-7B's 81 cut: 2 shared-block sites
MAMBA_LAYERS = 6        # Mamba2-370M's 48 cut (the script's time)
SSM_STEPS = 3
SITE_SLACK = 1e-4       # own-Gram objective against the other site's adapter
SITE_DIFF = 1e-2        # least relative difference of two sites' A @ B^T


def _model_sites(cfg) -> int:
    """Quantized linear applications of a model: 5 a Mamba layer, 7 a
    shared-block site (``gram`` and kernel launches a pass)."""
    return 5 * cfg.n_layers + 7 * cfg.n_hybrid_sites


def _site_objectives(torch, dense, qparams, qcfg, store) -> dict:
    """Per shared linear: ``objective[s][t]`` = ||X_s (A_t B_t^T - dW)||_F
    over site s's regularized Gram (the CLoQ objective site s's adapter
    minimizes), ``dW = W - Q`` of the pooled-Gram base, and the relative
    difference of the two first sites' ``A @ B^T``."""
    from repro_torch.core.cloq import regularize_gram
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    q, out = qcfg.quant, {}
    for key, ad in sorted(qparams["shared"]["site_lora"].items()):
        mod, lin = key.split("_", 1)
        base = qparams["shared"]["block"][mod][lin]
        W = dense["shared"]["block"][mod][lin]["w"].float()
        m = W.shape[0]
        dW = W - dequantize_int(unpack_codes(base["qcodes"], q.bits, m),
                                base["scales"], base["zeros"], q.group_size)
        S = ad["lora_a"].shape[0]
        if S < 2:
            raise Failed("the per-site check needs two shared-block sites")
        prods = [ad["lora_a"][t].float() @ ad["lora_b"][t].float().T
                 for t in range(S)]
        obj = []
        for s_ in range(S):
            H = regularize_gram(
                store.grams[f"sites.{s_}.shared.{mod}.{lin}"].float())
            row = []
            for P in prods:
                D = P - dW
                row.append(float(torch.sqrt((D * (H @ D)).sum())))
            obj.append(row)
            del H
        out[f"{mod}.{lin}"] = {"objective": obj, "ab_rel_diff": _rel(
            torch, prods[0], prods[1])}
    return out


def ssm_run(torch, dev, arch: str, layers: int) -> dict:
    """``arch`` at full width, ``layers`` deep: the train CLI's path (CLoQ
    4-bit g64 r64, calibration 2 x 8 x 128 tokens, 3 steps at 8 x 128),
    its losses against the plain path's on the same quantized params and
    batches, then the serve CLI's route for the family, the fixed-slot
    loop (batch 4, 8 requests x 16 tokens, cache 128) eager and captured.
    Held: finite losses within 1e-2 of the plain path's, an empty health
    report, captured tokens equal to eager ones, every kernel's launches
    (``gram`` and the kernels a linear: 5 a Mamba layer, 7 a shared-block
    site; ``flash_attention`` none) and, for a hybrid, each site's
    adapter at least as good on its own Gram as the other site's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    argv = ["--arch", arch, "--method", "cloq", "--bits", "4",
            "--group-size", "64", "--rank", "64", "--calib-batches", "2",
            "--batch", "8", "--seq-len", "128", "--steps", str(SSM_STEPS),
            "--seed", "0", "--device", str(dev)]
    args = train.build_parser().parse_args(argv)
    cfg = get_config(arch, n_layers=layers)
    hybrid = cfg.family == "hybrid"
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res, got = _spied_train(
        torch, train, args, cfg,
        inspect=(lambda *a: _site_objectives(torch, *a)) if hybrid else None)
    counts = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    qparams, qcfg = got["params"], got["cfg"]
    plain = _plain_losses(torch, dev, args, qparams, qcfg, SSM_STEPS)
    del res["state"]
    torch.cuda.empty_cache()
    routes = _kernel_routes(torch, dev, qparams, qcfg)
    logit_err = _kernel_vs_plain_logits(torch, dev, qparams, qcfg)
    kcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for graph in (False, True):
        ops.reset_launch_counts()
        sv = serve.serve_fixed_slots(qparams, kcfg, batch=4, cache_len=128,
                                     requests=8, max_new=16, seed=0,
                                     device=dev, graph=graph)
        runs["captured" if graph else "eager"] = {
            "outputs": [o.tolist() for o in sv["outputs"]],
            "slot_tok_s": sv["tok_s"], "seconds": sv["seconds"],
            "steps": sv["steps"], "requests_done": sv["requests_done"],
            "step_ms_median": 1e3 * _median(sv["step_s"]),
            "slot_tok_s_median_step": 4 / _median(sv["step_s"]),
            "logits_finite": sv["all_finite"],
            "launches": ops.launch_counts()}
    n = _model_sites(cfg)
    decodes = runs["captured"]["steps"]
    want_train = {"gram": n * args.calib_batches,
                  "dequant_matmul_lora": fused_a_step(cfg) * SSM_STEPS,
                  "dequant_matmul": 0, "flash_attention": 0}
    want_serve = {"gram": 0, "dequant_matmul_lora": 0,
                  "dequant_matmul": n * decodes, "flash_attention": 0}
    step_s, tokens = res["step_s"], args.batch * args.seq_len
    out = {"layers": layers, "argv": argv,
           "sites": {"mamba_layers": layers,
                     "shared_sites": cfg.n_hybrid_sites},
           "quantize_s": res["quantize_s"],
           "buckets": _bucket_chunks(got["lines"]),
           "bucket_lines": got["lines"], "memory_gb": got["memory"],
           "peak_mem_gb": {"train": train_peak,
                           "serve": torch.cuda.max_memory_allocated(dev)
                           / 1e9},
           "losses": res["losses"], "losses_plain": plain,
           "loss_rel_diff_vs_plain": max(abs(a - b) / abs(b) for a, b in
                                         zip(res["losses"], plain)),
           "grad_norms": res["grad_norms"], "step_s": step_s,
           "train_tok_s": tokens * len(step_s) / sum(step_s),
           "routes": routes, "kernel_vs_plain_logits": logit_err,
           "fixed_slots": {k: {f: v for f, v in r.items() if f != "outputs"}
                           for k, r in runs.items()},
           "captured_tokens_equal":
               runs["eager"]["outputs"] == runs["captured"]["outputs"],
           "launches": {"train": counts,
                        "serve_captured": runs["captured"]["launches"],
                        "serve_eager": runs["eager"]["launches"]},
           "health": res["health"].counts(),
           "health_events": res["health"].events,
           "health_checked": res["health"].checked}
    full = get_config(arch).n_layers
    if layers != full:
        out["reduced"] = {"n_layers": [full, layers]}
    bad = []
    if not all(math.isfinite(v) for v in res["losses"] + plain):
        bad.append("losses not finite")
    if out["loss_rel_diff_vs_plain"] > LOSS_LIMIT:
        bad.append(f"losses more than {LOSS_LIMIT} off the plain path's")
    if out["health"] or out["health_events"] or out["health_checked"] != \
            5 * layers + (7 if hybrid else 0):
        bad.append("health report not empty")
    if any(counts[k] != v for k, v in want_train.items()):
        bad.append(f"train launches, expected {want_train}")
    for k, r in runs.items():
        if any(r["launches"][n_] != v for n_, v in want_serve.items()):
            bad.append(f"serve {k} launches, expected {want_serve}")
        if r["requests_done"] != 8 or not r["logits_finite"]:
            bad.append(f"serve {k}: not every request served finite")
    if not out["captured_tokens_equal"]:
        bad.append("captured tokens differ from eager ones")
    if not logit_err["within"]:
        bad.append("kernel against plain decode logits beyond the limit")
    if hybrid:
        sites = got["inspected"]
        out["site_adapters"] = sites
        for lin, v in sites.items():
            o = v["objective"]
            if any(o[s_][s_] > o[s_][t] * (1 + SITE_SLACK)
                   for s_ in range(len(o)) for t in range(len(o))) or \
                    not v["ab_rel_diff"] > SITE_DIFF:
                bad.append(f"shared {lin}: per-site adapters {v}")
    if bad:
        raise Failed(f"ssm phase, {arch}: {bad}: {out}")
    return out


def ssm_phase(torch, dev, hybrid_layers: int) -> dict:
    """Mamba2-370M (``MAMBA_LAYERS``) and Zamba2-7B (``hybrid_layers``)
    deep through :func:`ssm_run`."""
    out = {}
    for arch, layers in (("mamba2-370m", MAMBA_LAYERS),
                         ("zamba2-7b", hybrid_layers)):
        out[arch] = ssm_run(torch, dev, arch, layers)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 11: the enc-dec family and the vision prefix at full width
# ---------------------------------------------------------------------------

VLM_LAYERS = 1          # Pixtral-12B's 40 cut: the script's time, and at 40
                        # layers CLoQ's f32 Grams (56.6 GB) and the bf16
                        # weights (24.5 GB) do not fit one card together
ENCDEC_STEPS = 3
SEAMLESS_LAYERS = 2     # its 12 + 12 cut to 2 + 2 (the script's time)


def encoder_output(torch, dev, params, cfg, rows: int, batch: int = 4):
    """The port's encoder (plain path) over seeded frame embeddings
    ``(batch, rows, d_model)``: a real ``enc_out`` to decode against."""
    import dataclasses
    from repro_torch.models.transformer import _encode
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    emb = torch.randn((batch, rows, cfg.d_model), generator=gen, device=dev)
    plain = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, use_kernel=False))
    with torch.no_grad():
        return _encode(params, plain, emb)


def _encdec_sites(cfg) -> int:
    """Quantized linears of a training pass (``gram`` and fused launches):
    7 a dense block, encoder and decoder, 4 a cross-attention block."""
    if cfg.family == "encdec":
        return 7 * (cfg.n_enc_layers + cfg.n_layers) + 4 * cfg.n_layers
    return 7 * cfg.n_layers


def _decode_times(torch, dev, qparams, kcfg, enc_out) -> dict:
    """One seamless decode step on the card (kernel path, 4 slots, cache
    128, at position 64) and its cross k/v projections alone (the fused
    kernel over all of ``enc_out``'s rows, 2 a decoder layer, through
    ``linear_apply`` as the step runs them), each timed as a captured
    graph: device ms and the cross k/v's share."""
    from repro_torch.models.modules import linear_apply
    from repro_torch.models.transformer import (_layers, decode_step,
                                                init_decode_cache)
    cache = init_decode_cache(kcfg, 4, 128, device=dev)
    cache["enc_out"].copy_(enc_out)
    cache["idx"].fill_(64)
    tok = torch.tensor([[3], [17], [101], [400]], device=dev)
    kv = [cp["xattn"][n] for _, cp in _layers(qparams["cross"], kcfg)
          for n in ("k", "v")]
    x = cache["enc_out"]

    def cross_kv():
        for p in kv:
            linear_apply(p, x, kcfg.quant)

    with torch.no_grad():
        step_ms = time_graph(
            torch, lambda: decode_step(qparams, kcfg, cache, tok))
        kv_ms = time_graph(torch, cross_kv)
    return {"step_ms": step_ms, "cross_kv_fused_ms": kv_ms,
            "cross_kv_calls": len(kv), "cross_kv_share": kv_ms / step_ms}


def encdec_run(torch, dev, arch: str, layers: int, method: str = "cloq",
               calib_batches: int = 2) -> dict:
    """``arch`` at full width, ``layers`` deep: the train CLI's path
    (``method`` 4-bit g64 r64, calibration ``calib_batches`` x 8 x 128
    tokens with their 32 encoder frames or 256 patches, 3 steps at 8 x
    128), its losses against the plain path's on the same quantized params
    and batches, then the serve CLI's route: seamless's fixed-slot loop
    (batch 4, 8 requests x 16 tokens, cache 128, against a real encoder
    output) or pixtral's engine (ranks 64 and 16, 4 tenants, 4 requests x
    8 tokens), eager and captured.  Held: finite losses within 1e-2 of the
    plain path's, an empty health report, captured tokens equal to eager
    ones, kernel against plain decode logits within ``logits_limit`` and
    every kernel's launches (see the module doc)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    argv = ["--arch", arch, "--method", method, "--bits", "4",
            "--group-size", "64", "--rank", "64", "--calib-batches",
            str(calib_batches), "--batch", "8", "--seq-len", "128",
            "--steps", str(ENCDEC_STEPS), "--seed", "0", "--device",
            str(dev)]
    args = train.build_parser().parse_args(argv)
    cfg = _family_config(arch, layers)
    encdec = cfg.family == "encdec"
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res, got = _spied_train(torch, train, args, cfg)
    counts = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    qparams, qcfg = got["params"], got["cfg"]
    plain = _plain_losses(torch, dev, args, qparams, qcfg, ENCDEC_STEPS)
    del res["state"]
    torch.cuda.empty_cache()
    routes = _kernel_routes(torch, dev, qparams, qcfg)
    logit_err = _kernel_vs_plain_logits(torch, dev, qparams, qcfg)
    kcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    torch.cuda.reset_peak_memory_stats(dev)
    L, n = layers, _encdec_sites(cfg)
    if encdec:
        enc_out = encoder_output(torch, dev, qparams, qcfg, 128)
        runs = {}
        for graph in (False, True):
            ops.reset_launch_counts()
            sv = serve.serve_fixed_slots(
                qparams, kcfg, batch=4, cache_len=128, requests=8,
                max_new=16, seed=0, device=dev, graph=graph,
                enc_out=enc_out)
            runs["captured" if graph else "eager"] = {
                "outputs": [o.tolist() for o in sv["outputs"]],
                "slot_tok_s": sv["tok_s"], "seconds": sv["seconds"],
                "steps": sv["steps"], "requests_done": sv["requests_done"],
                "step_ms_median": 1e3 * _median(sv["step_s"]),
                "logits_finite": sv["all_finite"],
                "launches": ops.launch_counts()}
        decodes = runs["captured"]["steps"]
        want_serve = {"gram": 0, "dequant_matmul": 9 * L * decodes,
                      "dequant_matmul_lora": 2 * L * decodes,
                      "flash_attention": L * decodes}
        served = {"fixed_slots": {k: {f: v for f, v in r.items()
                                      if f != "outputs"}
                                  for k, r in runs.items()},
                  "decode_times": _decode_times(torch, dev, qparams, kcfg,
                                                enc_out)}
        equal = runs["eager"]["outputs"] == runs["captured"]["outputs"]
        done = all(r["requests_done"] == 8 and r["logits_finite"]
                   for r in runs.values())
        cap_launches = runs["captured"]["launches"]
        eager_launches = runs["eager"]["launches"]
        del enc_out
    else:
        sv = _serve_both(torch, dev, arch, qparams, qcfg, ranks=SERVE_RANKS,
                         tenants=4, requests=4, max_new=8)
        cap = sv["captured"]
        decodes = sum(cap["decodes"].values())
        want_serve = {"gram": 0, "dequant_matmul_lora": 0,
                      "dequant_matmul": 7 * L * decodes,
                      "flash_attention": L * decodes}
        served = {"engine": {k: {f: sv[k][f] for f in
                                 ("slot_tok_s", "tok_s", "seconds",
                                  "step_ms_median", "decodes", "captured")}
                             for k in ("eager", "captured")}}
        equal = sv["tokens_equal"]
        done = cap["requests_done"] == 4 and all(len(o) == 8
                                                 for o in cap["outputs"])
        cap_launches, eager_launches = cap["launches"], \
            sv["eager"]["launches"]
    want_train = {"gram": n * calib_batches,
                  "dequant_matmul_lora": fused_a_step(cfg) * ENCDEC_STEPS,
                  "dequant_matmul": 0, "flash_attention": 0}
    step_s, tokens = res["step_s"], args.batch * args.seq_len
    out = {"layers": L, "method": method, "argv": argv,
           "quantize_s": res["quantize_s"],
           "buckets": _bucket_chunks(got["lines"]),
           "bucket_lines": got["lines"], "memory_gb": got["memory"],
           "peak_mem_gb": {"train": train_peak,
                           "serve": torch.cuda.max_memory_allocated(dev)
                           / 1e9},
           "losses": res["losses"], "losses_plain": plain,
           "loss_rel_diff_vs_plain": max(abs(a - b) / abs(b) for a, b in
                                         zip(res["losses"], plain)),
           "grad_norms": res["grad_norms"], "step_s": step_s,
           "train_tok_s": tokens * len(step_s) / sum(step_s),
           "routes": routes, "kernel_vs_plain_logits": logit_err,
           **served, "captured_tokens_equal": equal,
           "launches": {"train": counts, "serve_captured": cap_launches,
                        "serve_eager": eager_launches},
           "health": res["health"].counts(),
           "health_events": res["health"].events,
           "health_checked": res["health"].checked}
    full = get_config(arch)
    if L != full.n_layers:
        out["reduced"] = {"n_layers": [full.n_layers, L]}
        if encdec:
            out["reduced"]["n_enc_layers"] = [full.n_enc_layers, L]
    bad = []
    if not all(math.isfinite(v) for v in res["losses"] + plain):
        bad.append("losses not finite")
    if out["loss_rel_diff_vs_plain"] > LOSS_LIMIT:
        bad.append(f"losses more than {LOSS_LIMIT} off the plain path's")
    if out["health"] or out["health_events"] or out["health_checked"] != n:
        bad.append("health report not empty")
    if any(counts[k] != v for k, v in want_train.items()):
        bad.append(f"train launches, expected {want_train}")
    for k, got_l in (("captured", cap_launches), ("eager", eager_launches)):
        if any(got_l[k_] != v for k_, v in want_serve.items()):
            bad.append(f"serve {k} launches, expected {want_serve}")
    if not done:
        bad.append("not every request served finite")
    if not equal:
        bad.append("captured tokens differ from eager ones")
    if not logit_err["within"]:
        bad.append("kernel against plain decode logits beyond the limit")
    if bad:
        raise Failed(f"encdec phase, {arch}: {bad}: {out}")
    return out


def encdec_phase(torch, dev, vlm_layers: int) -> dict:
    """Seamless-M4T-medium ``SEAMLESS_LAYERS`` + ``SEAMLESS_LAYERS`` deep
    and Pixtral-12B ``vlm_layers`` deep through :func:`encdec_run`, CLoQ;
    at another
    depth than ``VLM_LAYERS`` Pixtral alone by RTN with no calibration
    batch (it reads no Gram: at 40 layers CLoQ's Grams would not fit)."""
    out = {}
    if vlm_layers == VLM_LAYERS:
        out["seamless-m4t-medium"] = encdec_run(
            torch, dev, "seamless-m4t-medium", SEAMLESS_LAYERS)
        torch.cuda.empty_cache()
        out["pixtral-12b"] = encdec_run(torch, dev, "pixtral-12b",
                                        vlm_layers)
    else:
        out["pixtral-12b"] = encdec_run(torch, dev, "pixtral-12b",
                                        vlm_layers, method="rtn",
                                        calib_batches=0)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 10: calibrated bit allocation, the only mixed-bit model
# ---------------------------------------------------------------------------

ALLOC_LAYERS = 1        # Qwen3-1.7B's 28 cut: the sweep is ~9 quantizes
ALLOC_STEPS = 2
ALLOC_CKPT = ROOT / "build" / "chip_smoke" / "alloc_ckpt"
ALLOC_OBJ_LIMIT = REL_FRO   # the engines phase's objective limit (1e-3)


def _alloc_objectives(torch, alloc, qparams, qcfg, dense, store) -> dict:
    """Each site group's proxy error as the sweep measured it for the
    chosen candidate, and ``tr(E^T H E)`` recomputed from the quantize
    engine's leaves (``E = W - Q - A B^T``, ``A``, ``B`` as stored) with
    the same Grams, summed over the group's sites."""
    from repro_torch.core.pipeline import to_eager_params
    from repro_torch.core.quantizer import dequantize_int, unpack_codes
    from repro_torch.models.modules import _group_of, packed_bits
    from repro_torch.utils import get_path
    q = to_eager_params(qparams, qcfg)
    d = to_eager_params(dense, qcfg)
    out = {}
    for row in alloc.table:
        total = 0.0
        for path in row["paths"]:
            lv = get_path(q, path)
            W = get_path(d, path)["w"].float()
            m = W.shape[0]
            codes = unpack_codes(lv["qcodes"], packed_bits(
                lv["qcodes"].shape[-2], m), m)
            Q = dequantize_int(codes, lv["scales"], lv["zeros"],
                               _group_of(lv["scales"], m))
            E = W - Q - lv["lora_a"].float() @ lv["lora_b"].float().T
            total += float((E * (store.grams[path].float() @ E)).sum())
        out[row["pattern"]] = {"sweep": row["err"], "engine": total,
                               "rel": abs(total - row["err"]) /
                               abs(row["err"])}
    return out


def _site_nbytes(torch, qparams, qcfg, paths) -> int:
    """Bytes of the quantized sites' leaves that ``quantize_model``
    returned (a bias is not a site leaf)."""
    from repro_torch.core.pipeline import to_eager_params
    from repro_torch.utils import get_path
    q = to_eager_params(qparams, qcfg)
    return sum(v.numel() * v.element_size() for path in paths
               for k, v in get_path(q, path).items() if k != "b")


def allocate_phase(torch, dev) -> dict:
    """Qwen3-1.7B at full width, ``ALLOC_LAYERS`` deep, through the train
    CLI's ``--auto-allocate`` path (``--method cloq --bits 4 --group-size
    64 --rank 64``: the sweep over {2, 3, 4} bits x ranks {0, 16, 64},
    calibration 2 x 8 x 128, ``ALLOC_STEPS`` steps at 8 x 128) under a
    ``--budget-mb`` midway between the uniform plans all (2 bits, rank 0)
    and all (4 bits, rank 64), then the fixed-slot decode of the trained
    model (batch 4, 4 requests x 8 tokens) eager and captured.  Held: the
    plan within budget; ``recipe_plan_bytes``, the plan's bytes and the
    returned sites' bytes equal; each group's sweep error within 1e-3 of
    ``tr(E^T H E)`` from the engine's leaves; finite losses, an empty
    health report; launches (``gram`` 2 calibrations x 14 sites x 2
    batches, ``dequant_matmul_lora`` 14 sites a step: every site is a
    packed INT site with 2-D LoRA, rank 0 too, and a step has 1024 rows,
    ``dequant_matmul`` 14 and ``flash_attention`` 2 a decode step);
    captured tokens equal to eager ones; kernel-vs-plain logits within
    :func:`logits_limit`; the checkpoint's manifest and its
    ``plan_fingerprint``."""
    import dataclasses
    import json
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (quantization_manifest,
                                           recipe_plan_bytes)
    from repro_torch.core.recipe import QuantRecipe, plan_fingerprint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models.modules import QSpec
    from repro_torch.optim import merge_params
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b", n_layers=ALLOC_LAYERS)
    uniform = {f"{b}b_r{r}": recipe_plan_bytes(cfg, QuantRecipe.single(
        "cloq", QSpec(bits=b, group_size=64, rank=r, method="cloq")))
        for b, r in ((2, 0), (4, 64))}
    budget = sum(uniform.values()) // 2
    shutil.rmtree(ALLOC_CKPT, ignore_errors=True)
    argv = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
            "--group-size", "64", "--rank", "64", "--auto-allocate",
            "--budget-mb", repr(budget / 2**20), "--calib-batches", "2",
            "--batch", "8", "--seq-len", "128", "--steps", str(ALLOC_STEPS),
            "--seed", "0", "--device", str(dev), "--ckpt-every", "0",
            "--ckpt-dir", str(ALLOC_CKPT)]
    args = train.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    keep = {}

    def inspect(dense, qparams, qcfg, store):
        keep["alloc_obj"] = (dense, store)
        return None

    res, got = _spied_train(torch, train, args, cfg, inspect=inspect)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    alloc, qparams, qcfg = res["allocation"], got["params"], got["cfg"]
    dense, store = keep.pop("alloc_obj")
    objectives = _alloc_objectives(torch, alloc, qparams, qcfg, dense, store)
    del dense, store
    site_bytes = _site_nbytes(torch, qparams, qcfg,
                              [p for r in alloc.table for p in r["paths"]])
    plan_bytes = recipe_plan_bytes(cfg, alloc.recipe)
    meta = json.loads((ALLOC_CKPT / f"step_{ALLOC_STEPS:08d}" /
                       "meta.json").read_text())
    saved = meta.get("bucket_manifest")
    fp = plan_fingerprint(quantization_manifest(qcfg, recipe=alloc.recipe))
    trained = merge_params(res["state"]["train"], res["state"]["frozen"])
    del res["state"], qparams
    torch.cuda.empty_cache()
    routes = _kernel_routes(torch, dev, trained, qcfg)
    kcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    logits = _kernel_vs_plain_logits(torch, dev, trained, qcfg)
    runs = {}
    for graph in (False, True):
        ops.reset_launch_counts()
        sv = serve.serve_fixed_slots(trained, kcfg, batch=4, cache_len=16,
                                     requests=4, max_new=8, seed=0,
                                     device=dev, graph=graph)
        runs["captured" if graph else "eager"] = {
            "outputs": [o.tolist() for o in sv["outputs"]],
            "slot_tok_s": sv["tok_s"], "steps": sv["steps"],
            "requests_done": sv["requests_done"],
            "logits_finite": sv["all_finite"],
            "step_ms_median": 1e3 * _median(sv["step_s"]),
            "launches": ops.launch_counts()}
    L, n = ALLOC_LAYERS, 7 * ALLOC_LAYERS
    decodes = runs["captured"]["steps"]
    want_train = {"gram": 2 * n * args.calib_batches,
                  "dequant_matmul_lora": fused_a_step(cfg) * ALLOC_STEPS,
                  "dequant_matmul": 0, "flash_attention": 0}
    want_serve = {"gram": 0, "dequant_matmul_lora": 0,
                  "dequant_matmul": n * decodes,
                  "flash_attention": L * decodes}
    chosen = {r["pattern"]: [r["spec"].qspec.bits, r["spec"].qspec.rank]
              for r in alloc.table}
    out = {"layers": L, "reduced": {"n_layers": [28, L]}, "argv": argv,
           "uniform_bytes": uniform, "budget_bytes": budget,
           "total_bytes": alloc.total_bytes, "plan_bytes": plan_bytes,
           "site_leaf_bytes": site_bytes,
           "proxy_error": alloc.total_error, "chosen": chosen,
           "mixed": len({tuple(v) for v in chosen.values()}) > 1,
           "objectives": objectives,
           "sweep_s": res["allocate_s"], "quantize_s": res["quantize_s"],
           "buckets": _bucket_chunks(got["lines"]),
           "peak_mem_gb": peak, "losses": res["losses"],
           "grad_norms": res["grad_norms"], "step_s": res["step_s"],
           "health": res["health"].counts(),
           "health_events": res["health"].events,
           "health_checked": res["health"].checked,
           "launches": {"train": counts,
                        "serve_captured": runs["captured"]["launches"],
                        "serve_eager": runs["eager"]["launches"]},
           "launches_expected": {"train": want_train, "serve": want_serve},
           "routes": routes, "kernel_vs_plain_logits": logits,
           "fixed_slots": {k: {f: v for f, v in r.items() if f != "outputs"}
                           for k, r in runs.items()},
           "captured_tokens_equal":
               runs["eager"]["outputs"] == runs["captured"]["outputs"],
           "ckpt_step": res["ckpt_step"],
           "ckpt_manifest": saved is not None,
           "ckpt_fingerprint_equal": saved is not None and
           plan_fingerprint(saved) == fp,
           # the checkpoint's plan, read from its manifest (load_plan on
           # a meta.json gives the default recipe, as in the JAX package)
           "ckpt_recipe_equal": saved is not None and QuantRecipe.from_dict(
               saved["recipe"]).to_dict() == alloc.recipe.to_dict(),
           "phase_s": time.perf_counter() - t_phase}
    bad = []
    if not alloc.total_bytes <= budget:
        bad.append("plan over budget")
    if not plan_bytes == alloc.total_bytes == site_bytes:
        bad.append("byte accounting differs")
    if any(v["rel"] > ALLOC_OBJ_LIMIT for v in objectives.values()):
        bad.append(f"sweep error off the engine's by more than "
                   f"{ALLOC_OBJ_LIMIT}")
    if not all(math.isfinite(v) for v in res["losses"]):
        bad.append("losses not finite")
    if out["health"] or out["health_events"] or out["health_checked"] != n:
        bad.append("health report not empty")
    if any(counts[k] != v for k, v in want_train.items()):
        bad.append(f"train launches, expected {want_train}")
    for k, r in runs.items():
        if any(r["launches"][n_] != v for n_, v in want_serve.items()):
            bad.append(f"serve {k} launches, expected {want_serve}")
        if r["requests_done"] != 4 or not r["logits_finite"]:
            bad.append(f"serve {k}: not every request served finite")
    if not out["captured_tokens_equal"]:
        bad.append("captured tokens differ from eager ones")
    if not logits["within"]:
        bad.append("kernel against plain decode logits beyond the limit")
    if not (out["ckpt_fingerprint_equal"] and out["ckpt_recipe_equal"]):
        bad.append("checkpoint manifest missing, or its fingerprint or "
                   "recipe differs")
    if bad:
        raise Failed(f"allocate phase: {bad}: {out}")
    return out


# ---------------------------------------------------------------------------
# levers: the memory levers of ModelConfig at full width and depth
# ---------------------------------------------------------------------------

LEVERS_BATCH, LEVERS_SEQ, LEVERS_STEPS = 8, 1024, 2
# (name, ModelConfig overrides): the recompute policies, then "full" with
# query-chunked attention and the chunked loss
LEVER_RUNS = (("none", {"remat": "none"}), ("full", {"remat": "full"}),
              ("tp_out", {"remat": "tp_out"}), ("dots", {"remat": "dots"}),
              ("full_chunked", {"remat": "full", "attn_chunk": 256,
                                "loss_chunk": 256}))
LEVER_LOSS_RTOL = 1e-5     # a recompute policy against "none"
CHUNK_LOSS_RTOL = 1e-3     # attn_chunk and loss_chunk against "none"


def fused_a_step(cfg) -> int:
    """``dequant_matmul_lora`` launches of one training step of a quantized
    model on the card under ``cfg.remat``: each of its INT-quantized 2-D
    linear applications (:func:`_train_sites`) runs once in the forward
    and once more in every recompute that covers it.  ``"full"`` (and any
    other string) and ``"tp_out"`` recompute each once, ``"dots"`` keeps
    the fused op's output and ``"none"`` recomputes nothing; in the stacked
    layout a hybrid's segment blocks run three times under ``"full"``
    (their segment's recompute and their own), and an enc-dec model is
    recomputed under ``"none"`` too; the eager enc-dec layout never is
    (``models/transformer.py``)."""
    sites = _train_sites(cfg)
    if cfg.family == "encdec":
        return sites * (2 if cfg.scan_layers and cfg.remat != "dots" else 1)
    if cfg.remat in ("none", "dots"):
        return sites
    if cfg.family == "hybrid" and cfg.scan_layers and cfg.remat != "tp_out":
        seg = 5 * cfg.n_hybrid_sites * cfg.hybrid_attn_every
        return 3 * seg + 2 * (sites - seg)
    if cfg.family == "hybrid" and not cfg.scan_layers:
        return 2 * 5 * cfg.n_layers + 7 * cfg.n_hybrid_sites
    return 2 * sites


def _train_sites(cfg) -> int:
    """Fused-kernel linear applications of one training forward."""
    if cfg.family in ("ssm", "hybrid"):
        return _model_sites(cfg)
    if cfg.family == "encdec":
        return _encdec_sites(cfg)
    return _sites_2d(cfg) * cfg.n_layers


def levers_phase(torch, dev) -> dict:
    """Qwen3-1.7B at full width and all 28 layers, RTN 4-bit, group 64,
    rank 64 (no Gram: quantization takes seconds), ``LEVERS_STEPS`` steps
    at ``LEVERS_BATCH`` x ``LEVERS_SEQ`` under each of ``LEVER_RUNS``, each
    from the same params and batches.  Held: every recompute policy's
    losses within ``LEVER_LOSS_RTOL`` of ``"none"``'s (equal bits
    expected), the chunked run's within ``CHUNK_LOSS_RTOL``, ``"full"``'s
    peak below ``"none"``'s, the fused launches a step :func:`fused_a_step`
    says.  If ``"none"`` does not fit the card, every run takes half the
    batch (``batch`` says which)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_state, make_train_step
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import OptConfig, tree_map
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp, qcfg, _ = quantize_model(params, cfg, [], recipe=QuantRecipe.single(
        "rtn", QSpec(bits=4, group_size=64, rank=64)))
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    qcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    ocfg = OptConfig(lr=3e-4, trainable="lora", total_steps=LEVERS_STEPS)

    def run(name: str, kw: dict, batch: int) -> dict:
        c = dataclasses.replace(qcfg, **kw)
        state = build_state(qp, ocfg)
        state["train"] = tree_map(torch.clone, state["train"])
        step = make_train_step(c, ocfg)
        stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=LEVERS_SEQ,
                                        global_batch=batch, seed=1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(LEVERS_STEPS):
            b = stream.next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = ops.launch_counts()
        tokens = batch * LEVERS_SEQ
        return {"overrides": kw, "losses": losses, "step_s": step_s,
                "tok_s": tokens * len(step_s) / sum(step_s),
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "fused_a_step": counts["dequant_matmul_lora"] / LEVERS_STEPS,
                "fused_a_step_expected": fused_a_step(c),
                "launches": counts}

    batch = LEVERS_BATCH
    runs: dict = {}
    try:
        runs["none"] = run("none", dict(LEVER_RUNS)["none"], batch)
    except torch.cuda.OutOfMemoryError:
        pass    # retried below, once the failed run's tensors are free
    if "none" not in runs:
        torch.cuda.empty_cache()
        batch //= 2
        runs["none"] = run("none", dict(LEVER_RUNS)["none"], batch)
    for name, kw in LEVER_RUNS[1:]:
        runs[name] = run(name, kw, batch)
    ref_losses = runs["none"]["losses"]
    for name, r in runs.items():
        r["loss_rel_diff_vs_none"] = max(abs(a - b) / abs(b) for a, b in
                                         zip(r["losses"], ref_losses))
    out = {"arch": "qwen3-1.7b", "layers": cfg.n_layers, "method": "rtn",
           "batch": batch, "seq_len": LEVERS_SEQ, "steps": LEVERS_STEPS,
           "batch_halved": batch != LEVERS_BATCH,
           "quantize_s": quantize_s, "runs": runs,
           "phase_s": time.perf_counter() - t_phase}
    del qp, runs
    torch.cuda.empty_cache()
    rs = out["runs"]
    bad = [n for n, r in rs.items()
           if r["fused_a_step"] != r["fused_a_step_expected"]
           or r["launches"]["gram"] or r["launches"]["flash_attention"]
           or not all(map(math.isfinite, r["losses"]))
           or r["loss_rel_diff_vs_none"] > (
               CHUNK_LOSS_RTOL if "attn_chunk" in r["overrides"]
               else LEVER_LOSS_RTOL)]
    if bad or not rs["full"]["peak_gb"] < rs["none"]["peak_gb"]:
        raise Failed(f"levers: {bad or 'full peak not below none'}: {out}")
    return out


# ---------------------------------------------------------------------------
# trace: span tracing and metrics through both CLIs
# ---------------------------------------------------------------------------

TRACE_LAYERS, TRACE_STEPS = 1, 2    # 1 layer: the script's time
TRACE_DIR = ROOT / "build" / "chip_smoke"


def _span_table(path: Path) -> tuple[dict, list]:
    """A chrome-trace file's events, and per span name (``X`` events) its
    count and total ms; instants (``i``) are counted under their name."""
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    if doc.get("displayTimeUnit") != "ms" or not evs or \
            any(e["ph"] not in ("X", "i", "M") for e in evs):
        raise Failed(f"trace {path}: not a chrome trace of X/i/M events")
    table: dict = {}
    for e in evs:
        if e["ph"] == "M":
            continue
        row = table.setdefault(e["name"], {"count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += e.get("dur", 0.0) / 1e3
    return table, evs


def trace_phase(torch, dev) -> dict:
    """Qwen3-1.7B at full width, ``TRACE_LAYERS`` layers, CLoQ 4-bit, g 64,
    r 64.  The train CLI's path (``obs.session`` around ``train.run``, as
    its ``main``), ``TRACE_STEPS`` steps, with ``--trace-out`` and
    ``--metrics-out`` under ``REPRO_TRACE_SYNC=1``, then once more with
    the tracer off (the step time both ways); the serve CLI's engine (2
    tenants over ranks 64/16, captured decode) with ``--trace-out`` and
    ``--metrics-out``, then the same requests on that engine with the
    tracer off.  Both traces and snapshots go under ``build/chip_smoke/``.
    Held: the files parse; ``train.step`` x steps, ``bucket.execute`` x
    buckets (the ``quant.plan`` span's count), ``serve.decode`` x the
    engine's bucket decodes; the same tokens traced and untraced; the
    snapshots' step and token counters.  Reported: each span's count and
    total ms, the share of ``quant.model`` that the synced
    ``bucket.execute`` spans cover."""
    import os
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    t_phase = time.perf_counter()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    files = {k: TRACE_DIR / f"{k}.json" for k in
             ("trace-train", "metrics-train", "trace-serve", "metrics-serve")}
    for f in files.values():
        f.unlink(missing_ok=True)
    cfg = get_config("qwen3-1.7b", n_layers=TRACE_LAYERS)
    targv = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
             "--group-size", "64", "--rank", "64", "--calib-batches", "2",
             "--batch", "8", "--seq-len", "128", "--steps", str(TRACE_STEPS),
             "--seed", "0", "--device", str(dev)]
    prev = os.environ.get("REPRO_TRACE_SYNC")
    os.environ["REPRO_TRACE_SYNC"] = "1"
    try:
        args = train.build_parser().parse_args(
            targv + ["--trace-out", str(files["trace-train"]),
                     "--metrics-out", str(files["metrics-train"])])
        obs.metrics.reset()
        obs.trace.get_tracer().clear()   # a session keeps past events
        ops.reset_launch_counts()
        with obs.session(args.trace_out, args.metrics_out):
            traced = train.run(args, cfg)
        launches_train = ops.launch_counts()
        del traced["state"]
        untraced = train.run(train.build_parser().parse_args(targv), cfg)
        del untraced["state"]
        sargv = ["--arch", "qwen3-1.7b", "--tenants", "2", "--ranks", "64,16",
                 "--batch", "4", "--cache-len", "128", "--requests", "4",
                 "--max-new", "8", "--seed", "0", "--device", str(dev),
                 "--trace-out", str(files["trace-serve"]),
                 "--metrics-out", str(files["metrics-serve"])]
        sargs = serve.build_parser().parse_args(sargv)
        obs.metrics.reset()
        obs.trace.get_tracer().clear()
        ops.reset_launch_counts()
        with obs.session(sargs.trace_out, sargs.metrics_out):
            sres = serve.run(sargs, cfg)
        launches_serve = ops.launch_counts()
        engine = sres["engine"]
        decodes = sum(engine.decodes.values())
        again = serve.serve_engine(engine, sres["tenants"],
                                   requests=sargs.requests,
                                   max_new=sargs.max_new, seed=sargs.seed)
    finally:
        if prev is None:
            os.environ.pop("REPRO_TRACE_SYNC", None)
        else:
            os.environ["REPRO_TRACE_SYNC"] = prev
    ttab, tevs = _span_table(files["trace-train"])
    stab, _ = _span_table(files["trace-serve"])
    tsnap = json.loads(files["metrics-train"].read_text())
    ssnap = json.loads(files["metrics-serve"].read_text())
    plan = [e for e in tevs if e["name"] == "quant.plan"]
    buckets = plan[0]["args"]["buckets"] if len(plan) == 1 else -1
    quant_ms = ttab.get("quant.model", {}).get("ms", 0.0)
    execute_ms = ttab.get("bucket.execute", {}).get("ms", 0.0)
    outputs = [list(map(int, o)) for o in sres["serve"]["outputs"]]
    out = {"arch": "qwen3-1.7b", "layers": TRACE_LAYERS,
           "files": {k: str(f.relative_to(ROOT)) for k, f in files.items()},
           "train_spans": ttab, "serve_spans": stab, "buckets": buckets,
           "bucket_execute_share_of_quantize":
               execute_ms / quant_ms if quant_ms else 0.0,
           "train_step_s": {"traced": traced["step_s"],
                            "untraced": untraced["step_s"]},
           "losses": {"traced": traced["losses"],
                      "untraced": untraced["losses"]},
           "serve_decodes": decodes,
           "serve_tokens_equal_untraced":
               outputs == [list(map(int, o)) for o in again["outputs"]],
           "launches": {"train": launches_train, "serve": launches_serve},
           "snapshot_counters": {"train": tsnap.get("counters", {}),
                                 "serve": ssnap.get("counters", {})},
           "phase_s": time.perf_counter() - t_phase}
    want = {"train.step": TRACE_STEPS, "bucket.execute": buckets}
    short = {k: n for k, n in want.items()
             if ttab.get(k, {}).get("count") != n}
    if stab.get("serve.decode", {}).get("count") != decodes or decodes < 1:
        short["serve.decode"] = decodes
    if short or buckets < 1 or not out["serve_tokens_equal_untraced"] or \
            sres["serve"]["requests_done"] != sargs.requests or \
            not all(map(math.isfinite, traced["losses"])):
        raise Failed(f"trace: spans {short}, buckets {buckets}: {out}")
    return out


DIST_DIR = ROOT / "build" / "chip_smoke" / "distributed"
DIST_RANKS = 2
# the methods the ranks quantize sharded: CLoQ (one all-reduce a bucket)
# and LoftQ (one an AltMin round); gptq, qlora and rtn run sharded in the
# CPU tests (tests/test_torch_distributed.py)
DIST_METHODS = ("cloq", "loftq")
DIST_LORA_REL = 5e-3       # A @ B^T, the reference's sharded tolerance
DIST_BACKEND = ("gloo", "one card: NCCL refuses two ranks on one device; "
                "gloo takes CUDA tensors for all_reduce and broadcast")
DIST_DECODE_STEPS = 8      # the restored checkpoint's decode: 4 x 8 tokens
# leaves the distributed phase's checkpoint leaves out: dense and unsharded,
# the input params' own (the parent decodes with them)
DIST_DENSE = ("embed", "head")
# the fields whose limit grows to NUDGE_FACTOR x the one-ulp nudge's: CLoQ's
# codes and A @ B^T on the site (one Gram ulp moves OPTQ's near-ties, as in
# the engines phase); LoftQ's every field, at the largest of its bucket's
# sites under one ulp up and one down on every weight (its grids are
# fitted to W - A B^T, and the 5 AltMin rounds carry any ulp of one solve
# into the next rounding, a different distance on each site: PERF.md, PR
# 24 runs B-D)
DIST_NUDGED = {"cloq": ("code_flips", "lora_ab"),
               "loftq": ("code_flips", "scales", "zeros", "lora_ab",
                         "gram_error")}


def _dist_rank(rank: int, work: str, methods: tuple, extras: bool) -> None:
    """One rank of the distributed phase (2 ranks on ``cuda:0`` over
    gloo).  Builds the engine model (the same params from seed 0 and
    calibration batches on every rank), calibrates through ``gram`` and
    quantizes it with ``quantize_model(engine="batched",
    mesh=make_model_mesh(2))`` for each of ``methods``; rank 0 saves each
    run's gathered leaves as ``<method>.pt``.  With ``extras``: the cost
    model (``calibrate(mesh)``, ``explain`` for each bucket at k = 2, the
    CLoQ run once more under it), the sharded CLoQ tree saved with its
    manifest and restored sharded (each rank's blocks held bit-equal), and
    on rank 0 the train CLI with ``--cost-cal auto`` at 2 layers (RTN, 1
    step).  Each rank writes ``rank<r>.json``: seconds, ``[bucket]``
    lines, all-reduce count and bytes, launches."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.batched import BucketSpec
    from repro_torch.core.costmodel import CostModel, calibrate
    from repro_torch.core.pipeline import (quantization_manifest,
                                           quantize_model, to_eager_params)
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import parallel
    from repro_torch.utils import tree_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    work = Path(work)
    mesh = make_model_mesh(DIST_RANKS)
    cfg, params, calib, recipe = _engine_model(torch, dev)
    ops.reset_launch_counts()
    parallel.reset_allreduce_stats()
    out: dict = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
    kept = None
    for method in methods:
        rec = QuantRecipe.single(method, recipe.qspec)
        before = dict(parallel.ALLREDUCE_STATS)
        lines: list[str] = []
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        qp, qcfg, _ = quantize_model(params, cfg, calib, recipe=rec,
                                     engine="batched", mesh=mesh,
                                     progress=lines.append)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        full = parallel.gather_tree(qp)
        if rank == 0:           # the blocks' leaves: every quantized site
            flat = tree_paths(to_eager_params(full, qcfg))
            torch.save({k: v.cpu() for k, v in flat.items()
                        if k.startswith("blocks.")}, work / f"{method}.pt")
        del full
        out["runs"][method] = {
            "quantize_s": dt, "bucket_lines": lines,
            "allreduce_calls": parallel.ALLREDUCE_STATS["calls"]
            - before["calls"],
            "allreduce_bytes": parallel.ALLREDUCE_STATS["bytes"]
            - before["bytes"]}
        if method == "cloq":
            kept = (qp, qcfg)
        del qp
    if extras:
        t0 = time.perf_counter()
        cal = calibrate(mesh, path=str(work / "costcal.json"), force=True)
        cm = CostModel(cal)
        manifest = quantization_manifest(cfg, recipe=recipe, mesh=mesh)
        out["cost_model"] = {
            "calibrate_s": time.perf_counter() - t0,
            "table": {k: getattr(cal, k) for k in (
                "flops_per_s", "bytes_per_s", "dispatch_s",
                "psum_latency_s", "psum_bytes_per_s", "shard_efficiency")},
            "explain": [cm.explain(BucketSpec(**b["spec"]), len(b["tasks"]),
                                   DIST_RANKS)
                        for b in manifest["buckets"]]}
        lines = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp_cm, _, _ = quantize_model(params, cfg, calib, recipe=recipe,
                                     engine="batched", mesh=mesh,
                                     cost_model=cm, progress=lines.append)
        torch.cuda.synchronize()
        out["cost_model"].update(quantize_s=time.perf_counter() - t0,
                                 bucket_lines=lines)
        del qp_cm
        # the quantized tree without the embedding and head (dense, as the
        # input params; 2.5 GB of f32 to write and read back)
        qp = {k: v for k, v in kept[0].items() if k not in DIST_DENSE}
        t0 = time.perf_counter()
        ckpt.save_tree(qp, str(work / "ckpt"), 1, manifest=manifest)
        dist.barrier()
        back, _ = ckpt.restore_tree(str(work / "ckpt"), mesh=mesh)
        want, got = tree_paths(qp), tree_paths(back)
        unequal = [p for p, leaf in want.items() if p not in got or
                   parallel.is_sharded(got[p]) != parallel.is_sharded(leaf)
                   or not torch.equal(parallel.local_of(got[p]).cpu(),
                                      parallel.local_of(leaf).cpu())]
        out["restore"] = {
            "s": time.perf_counter() - t0, "leaves": len(want),
            "sharded_leaves": sum(parallel.is_sharded(v)
                                  for v in want.values()),
            "local_cols": {p: list(parallel.local_of(v).shape)
                           for p, v in want.items()
                           if p.endswith("attn.q.qcodes")},
            "unequal": unequal}
        del back
        if rank == 0:
            from repro_torch.configs import get_config
            from repro_torch.launch import train
            os.environ["REPRO_COSTCAL"] = str(work / "costcal-auto.json")
            targv = ["--arch", "qwen3-1.7b", "--method", "rtn", "--bits",
                     "4", "--group-size", "64", "--rank", "64",
                     "--calib-batches", "1", "--batch", "8", "--seq-len",
                     "128", "--steps", "1", "--seed", "0", "--device",
                     str(dev), "--cost-cal", "auto"]
            t0 = time.perf_counter()
            res = train.run(train.build_parser().parse_args(targv),
                            get_config("qwen3-1.7b", n_layers=2))
            out["train_cli"] = {
                "s": time.perf_counter() - t0, "losses": res["losses"],
                "costcal_written": (work / "costcal-auto.json").is_file()}
            del res
        dist.barrier()
    out["launches"] = ops.launch_counts()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def dist_reference(torch, dev, eng: dict | None = None,
                   methods: tuple = DIST_METHODS) -> dict:
    """The unsharded side of the distributed checks on this card: the
    engine model, its Grams, the batched engine's leaves for each method
    and each site's one-ulp nudge.  CLoQ's (the sequential engine against
    itself with every Gram entry one ulp off) come from the engines
    phase's ``eng`` when given.  LoftQ's unsharded run takes each round's
    factors through the Gram trick (``loftq_init(gram_trick=True)``, the
    sharded run's factorization on all columns): over 5 AltMin rounds the
    ``eigh``/``svd`` difference of one solve moves the next rounding, so
    at full width the two factorizations drift apart (PERF.md, PR 24 run
    B) whatever the sharding does; its nudge is the largest diff of the
    same run with every block weight one ulp up, and one ulp down (LoftQ
    reads no Gram)."""
    import functools
    from repro_torch.core import batched, loftq
    from repro_torch.core.recipe import QuantRecipe
    if eng is None:
        model = _engine_model(torch, dev)
        flat, store, _, dt, _, _ = _quantize_eager(torch, dev, model,
                                                   engine="batched")
        ref = {"model": model, "store": store, "leaves": {"cloq": flat},
               "quantize_s": {"cloq": dt},
               "nudge": {"cloq": _nudges(torch, model, store)}}
    else:
        ref = {"model": eng["model"], "store": eng["store"],
               "leaves": {"cloq": eng["clean"]},
               "quantize_s": {"cloq": eng["quantize_s"]},
               "nudge": {"cloq": {s: d["nudge"]
                                  for s, d in eng["per_site"].items()}}}
    cfg, params, calib, recipe = ref["model"]
    if "loftq" not in methods:
        return ref
    rec = QuantRecipe.single("loftq", recipe.qspec)
    batched.loftq_init = functools.partial(loftq.loftq_init, gram_trick=True)
    try:
        flat, _, _, dt, _, _ = _quantize_eager(
            torch, dev, (cfg, params, calib, rec), engine="batched")
        ref["leaves"]["loftq"], ref["quantize_s"]["loftq"] = flat, dt
        nudges = []
        for to in (float("inf"), float("-inf")):
            nudged, _, _, _, _, _ = _quantize_eager(
                torch, dev, (cfg, _nudged_weights(torch, params, to), calib,
                             rec), engine="batched")
            nudges.append(_site_diffs(torch, ref, nudged, flat))
            del nudged
    finally:
        batched.loftq_init = loftq.loftq_init
    ref["nudge"]["loftq"] = {site: {k: max(n[site][k] for n in nudges)
                                    for k in nudges[0][site]}
                             for site in nudges[0]}
    return ref


def _nudged_weights(torch, params: dict, to: float) -> dict:
    """``params`` with every block weight ``w`` one ulp towards ``to`` (a
    new tree; the other leaves shared)."""
    from repro_torch.utils import set_path, tree_paths
    out: dict = {}
    for p, v in tree_paths(params).items():
        if p.startswith("blocks.") and p.endswith(".w"):
            v = torch.nextafter(v, torch.full_like(v, to))
        set_path(out, p, v)
    return out


def _site_diffs(torch, ref: dict, got: dict, want: dict) -> dict:
    """``_site_diff`` of every site of the engine model, ``got`` against
    ``want`` (flat eager leaves)."""
    from repro_torch.core.pipeline import (quantizable_linear_paths,
                                           to_eager_params)
    from repro_torch.utils import get_path
    cfg, params = ref["model"][0], ref["model"][1]
    eparams = to_eager_params(params, cfg)
    keys = ("qcodes", "scales", "zeros", "lora_a", "lora_b")
    dev = params["embed"]["w"].device
    out = {}
    with torch.no_grad():
        for site in quantizable_linear_paths(eparams):
            out[site] = _site_diff(
                torch, {k: got[f"{site}.{k}"].to(dev) for k in keys},
                {k: want[f"{site}.{k}"].to(dev) for k in keys},
                get_path(eparams, site)["w"].float(),
                ref["store"].grams[site])
    return out


def _nudges(torch, model, store) -> dict:
    """Each site's one-ulp nudge diff, as the engines phase measures it."""
    from repro_torch.core.batched import task_key
    from repro_torch.core.pipeline import (_quantize_one,
                                           quantizable_linear_paths,
                                           to_eager_params)
    from repro_torch.utils import get_path
    cfg, params, _, recipe = model
    eparams = to_eager_params(params, cfg)
    out = {}
    with torch.no_grad():
        for i, site in enumerate(quantizable_linear_paths(eparams)):
            W = get_path(eparams, site)["w"].float()
            H = store.grams[site]
            seq = _quantize_one(W, H, recipe.qspec, "cloq", task_key(0, i))
            nudged = _quantize_one(
                W, torch.nextafter(H, torch.full_like(H, float("inf"))),
                recipe.qspec, "cloq", task_key(0, i))
            out[site] = _site_diff(torch, nudged, seq, W, H)
    return out


def dist_ranks(torch, work: Path, methods: tuple = DIST_METHODS,
               extras: bool = True) -> tuple[list, dict]:
    """Spawn the ranks (:func:`_dist_rank`) and read back their JSON and
    rank 0's gathered leaves."""
    import shutil
    from repro_torch.launch.mesh import spawn_ranks
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spawn_ranks(_dist_rank, DIST_RANKS, backend=DIST_BACKEND[0],
                device="cuda", args=(str(work), tuple(methods), extras),
                store_dir=str(work))
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    leaves = {m: torch.load(work / f"{m}.pt") for m in methods}
    return ranks, leaves


def dist_compare(torch, dev, ref: dict, method: str, got: dict) -> dict:
    """One method's gathered sharded leaves against the unsharded batched
    engine's on the card, site by site (``_site_diff``: code flips,
    scales, zeros, ``A @ B^T``, the calibrated objective ``gram_error``),
    held to the engines phase's limits (codes 0.005, scales, zeros and
    ``gram_error`` 1e-3) and ``A @ B^T`` to 5e-3, each field of
    ``DIST_NUDGED`` to twice the one-ulp nudge's where that is larger (on
    the site for CLoQ, the largest of its bucket's sites for LoftQ).
    LoftQ is held against its Gram-trick run (:func:`dist_reference`).
    Returns the per-site diffs with their limits, the worst of each, and
    the failures."""
    base = {"code_flips": FLIP_BUDGET, "lora_ab": DIST_LORA_REL,
            "scales": REL_FRO, "zeros": REL_FRO, "gram_error": REL_FRO}
    per_site, worst, failed = {}, {}, []
    diffs = _site_diffs(torch, ref, got, ref["leaves"][method])
    nudges = ref["nudge"][method]
    if method == "loftq":         # a bucket's sites: one shape
        shape = {s: tuple(ref["leaves"][method][f"{s}.qcodes"].shape)
                 for s in diffs}
        nudges = {s: {k: max(nudges[o][k] for o in diffs
                             if shape[o] == shape[s]) for k in nudges[s]}
                  for s in diffs}
    for site, d in diffs.items():
        nudge = nudges[site]
        lim = {k: (max(v, NUDGE_FACTOR * nudge[k])
                   if k in DIST_NUDGED[method] else v)
               for k, v in base.items()}
        per_site[site] = {**d, "nudge": nudge, "limits": lim}
        for k, v in d.items():
            worst[k] = max(worst.get(k, 0.0), v)
            if not v <= lim[k]:
                failed.append([site, k, v, lim[k]])
    return {"per_site": per_site, "worst": worst, "failed": failed}


def distributed_phase(torch, dev, eng: dict | None = None) -> dict:
    """The distributed quantization engine: ``DIST_RANKS`` ranks on
    ``cuda:0`` over gloo (``DIST_BACKEND``: one card, and NCCL refuses two
    ranks on one device) quantize the engine model (Qwen3-1.7B, full width,
    ``ENGINE_LAYERS`` deep, f32, 4-bit g64 r64) column-sharded for each of
    ``DIST_METHODS`` (:func:`_dist_rank`), held against the unsharded
    batched engine's leaves on the same card (:func:`dist_compare`; the
    engines phase's run for CLoQ, the Gram-trick run for LoftQ).  Then the
    cost model's table, paths and ``explain`` lines, the sharded
    checkpoint restored sharded in the ranks (equal bits) and here whole:
    4 requests x ``DIST_DECODE_STEPS`` tokens decoded through the kernels
    and the plain path, held to ``logits_limit``.  ``quant.model`` seconds
    sharded against unsharded are no speed-up: both ranks share one
    card.  Launches are summed over the ranks and this process."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ref = dist_reference(torch, dev, eng)
    t_ranks = time.perf_counter()
    ranks, leaves = dist_ranks(torch, DIST_DIR)
    ranks_s = time.perf_counter() - t_ranks
    cmp = {m: dist_compare(torch, dev, ref, m, leaves[m])
           for m in DIST_METHODS}
    del leaves
    ops.reset_launch_counts()
    tree, meta = ckpt.restore_tree(str(DIST_DIR / "ckpt"), device=dev)
    cfg, params = ref["model"][0], ref["model"][1]
    tree.update({k: params[k] for k in DIST_DENSE if k in params})
    import dataclasses
    qcfg = dataclasses.replace(cfg, quant=ref["model"][3].qspec)
    lg = _kernel_vs_plain_logits(torch, dev, tree, qcfg,
                                 steps=DIST_DECODE_STEPS)
    parent = ops.launch_counts()
    del tree
    launches = {k: parent.get(k, 0) + sum(r["launches"].get(k, 0)
                                          for r in ranks)
                for k in ("gram", "dequant_matmul_lora", "dequant_matmul",
                          "flash_attention")}
    r0 = ranks[0]
    paths = {m: [[f.split("=", 1)[1] for f in ln.split()
                  if f.startswith(("path=", "shards="))]
                 for ln in r0["runs"][m]["bucket_lines"]]
             for m in DIST_METHODS}
    out = {"ranks": DIST_RANKS, "backend": DIST_BACKEND[0],
           "why": DIST_BACKEND[1], "device": "cuda:0 (both ranks)",
           "methods": list(DIST_METHODS), "bucket_paths": paths,
           "allreduce": {m: {"calls": r0["runs"][m]["allreduce_calls"],
                             "bytes": r0["runs"][m]["allreduce_bytes"]}
                         for m in DIST_METHODS},
           "quantize_s": {m: {"sharded": [r["runs"][m]["quantize_s"]
                                          for r in ranks],
                              "unsharded": ref["quantize_s"][m]}
                          for m in DIST_METHODS},
           "speedup_note": "no speed-up: both ranks share one card",
           "worst": {m: c["worst"] for m, c in cmp.items()},
           "nudge_worst": {m: {k: max(d[k] for d in ref["nudge"][m].values())
                               for k in c["worst"]}
                           for m, c in cmp.items()},
           "failed": {m: c["failed"] for m, c in cmp.items()},
           "per_site": {m: c["per_site"] for m, c in cmp.items()},
           "cost_model": r0["cost_model"],
           "cost_model_paths": [[f.split("=", 1)[1] for f in ln.split()
                                 if f.startswith(("path=", "shards="))]
                                for ln in r0["cost_model"]["bucket_lines"]],
           "restore": [{k: r["restore"][k] for k in
                        ("s", "leaves", "sharded_leaves", "local_cols",
                         "unequal")} for r in ranks],
           "manifest_buckets": [[b["spec"]["n_shards"], len(b["tasks"])]
                                for b in meta[ckpt.MANIFEST_KEY]["buckets"]],
           "train_cli": r0["train_cli"], "logits": lg,
           "launches": launches,
           "launches_by": {"ranks": [r["launches"] for r in ranks],
                           "parent": parent},
           "ranks_s": ranks_s,
           "phase_s": time.perf_counter() - t_phase}
    sharded = all(p == ["sharded", str(DIST_RANKS)]
                  for m in DIST_METHODS for p in paths[m])
    if any(c["failed"] for c in cmp.values()) or not sharded or \
            any(r["restore"]["unequal"] for r in ranks) or \
            not lg["within"] or not r0["train_cli"]["costcal_written"] or \
            not all(math.isfinite(x) for x in r0["train_cli"]["losses"]) or \
            out["allreduce"]["cloq"]["calls"] < 1 or \
            launches["gram"] < 1 or launches["dequant_matmul"] < 1 or \
            launches["flash_attention"] < 1:
        raise Failed(f"distributed: {out}")
    return out


SHARDED_DIR = ROOT / "build" / "chip_smoke" / "train_sharded"
SHARDED_MESH = (2, 2)        # (data, model): 4 gloo ranks sharing cuda:0
SHARDED_LR = 3e-4            # the train CLI's default
SHARDED_QSPEC = dict(bits=4, group_size=64, rank=64)
# step 1's gradients, sharded against unsharded (relative Frobenius): a
# row-parallel linear rounds each rank's bf16 partial sum once more
# before the all-reduce, 2^-8 of it at most; a step's gradient crosses 2
# row linears a layer forward and again backward over 2 layers, 8
# crossings, so at most 8 x 2^-8 if every one added up; a lost reduction
# over "model" leaves each rank about half of a gradient
SHARDED_GRAD_REL = 8 * 2.0 ** -8
SHARDED_NORM_REL = 1e-2      # step 1's gradient norm
SHARDED_DECODE = (4, 8, 128)     # batch, tokens, cache of the decode
SHARDED_MOE_LAYERS = 2       # OLMoE-1B-7B's 16 cut
SHARDED_MOE_STEPS = 2
SHARDED_MOE_CF = 8.0         # nothing drops (the JAX EP test's setting)
# the families at full width: (arch, layers (an enc-dec model's on each
# side), method).  Qwen3-1.7B's 28 layers cut to 2; Mamba2-370M's 48 to
# 2; Zamba2-7B's 81 to 6, the fewest that reach its one shared-block
# site; Seamless's 12 + 12 to 1 + 1; Pixtral-12B's 40 to 1 with its 256
# prefix embeddings.  An RTN model's lora_b starts at zero (its lora_a
# gradients too): its gradients are held at step 2, from the parent's
# state after step 1.  Qwen3-1.7B also runs ``ef_psum_int8`` on its
# step-1 gradients (``SHARDED_EF``)
SHARDED_FAMILIES = (("qwen3-1.7b", 2, "cloq"), ("mamba2-370m", 2, "cloq"),
                    ("zamba2-7b", 6, "rtn"),
                    ("seamless-m4t-medium", 1, "cloq"),
                    ("pixtral-12b", 1, "rtn"))
SHARDED_FAMILY_STEPS = 2
SHARDED_EF = ("qwen3-1.7b",)
# the sequence-sharded decode (seq_kv): Qwen3-30B-A3B at full width, 1 of
# its 48 layers, RTN, on 8 gloo ranks sharing cuda:0 as a (data 1, model
# 8) mesh.  Its 4 KV heads on 8 ranks give half a KV head and 4 whole q
# heads a rank (the production pattern of Qwen3 and Pixtral at model 16),
# so cache_specs shards the cache's sequence: 8 of its 64 positions a
# rank.  40 greedy tokens from position 0 cross five shard boundaries,
# and ranks 5-7 hold no valid key on any step.  Experts: 16 a rank.  In
# f32: in bf16 the row-sharded and gathered projections round differently
# from the whole ones (as in every sharded decode), and a router near-tie
# among 128 experts turns an ulp into another expert's output at some
# steps (PERF.md, run B); in f32 the two decodes differ by summation
# order only
SEQ_KV_ARCH = "qwen3-moe-30b-a3b"
SEQ_KV_DTYPE = "float32"
SEQ_KV_LAYERS = 1
SEQ_KV_MESH = (1, 8)
SEQ_KV_DECODE = (4, 40, 64)     # batch, tokens, cache


def _layer_calls(kind: str, first: bool, seq: bool, runs: int = 2
                 ) -> tuple[int, int, int]:
    """(all-reduces, all-gathers, reduce-scatters) of one layer in a
    ``"lora"`` step a rank on the (data 2, model 2) mesh, its forward run
    ``runs`` times (2 under ``remat="full"``, 3 for a hybrid segment's
    blocks).  ``kind``: "dense" (attention and MLP: the row linears o and
    down; backward, the input gradient of each column linear whose input
    needs one, q/k/v/gate/up, not layer 0's q/k/v, the embedding being
    frozen, and each whole LoRA factor, 5 ``lora_a`` and 2 ``lora_b``);
    "mamba" (out_proj and the gated norm's sum of squares; backward,
    z/x_proj's input, their ``lora_a`` and out_proj's ``lora_b``, the
    rank's heads of dt and of B/C, and the sum of squares' gradient);
    "cross" (o; backward, q's input, the encoder output into k and v, 4
    whole factors); "encoder" (a dense layer never sequence-sharded).
    Under ``seq_shard`` a sub-layer's row linear reduce-scatters instead of
    all-reducing, one all-gather of S a sub-layer forward and one of the
    reduce-scatter's gradient."""
    rows = {"dense": 2, "encoder": 2, "mamba": 1, "cross": 1}[kind]
    back = {"dense": (2 if first else 5) + 7,
            "encoder": (2 if first else 5) + 7,
            "mamba": (0 if first else 2) + 3 + 2 + 1,
            "cross": 1 + 2 + 4}[kind]
    fwd = 1 if kind == "mamba" else 0     # the gated norm's sum
    if not seq or kind == "encoder":
        return back + runs * (rows + fwd), 0, 0
    return back + runs * fwd, runs * rows + rows, runs * rows


def predicted_collectives(cfg, seq_shard: bool) -> dict:
    """Collective calls of one ``trainable="lora"`` step a rank of a model
    of ``cfg``'s structure (every family, scan-stacked, ``remat="full"``)
    on the (data 2, model 2) mesh, from the layout table of
    ``models/parallel.py``, ``models/modules.py``, ``models/attention.py``
    and ``models/ssm.py`` (:func:`_layer_calls` a layer).  Once a step:
    the vocab-parallel embedding's all-reduce, the cross-entropy's MAX and
    SUM, the loss's sum over "data", the head input's gradient, the
    gradients' sum over "data", the clip's norm over "model", and under
    ``seq_shard`` the final norm's gather.  A hybrid's first ``sites x
    every`` blocks run in checkpointed segments around their checkpointed
    blocks (forward three times), each site a dense layer after them; an
    enc-dec model's decoder layer is a dense layer and a cross-attention
    over the encoder's layers."""
    layers = []
    if cfg.family == "encdec":
        layers += [("encoder", i == 0, 2) for i in range(cfg.n_enc_layers)]
        for i in range(cfg.n_layers):
            layers += [("dense", i == 0, 2), ("cross", False, 2)]
    elif cfg.family in ("ssm", "hybrid"):
        seg = cfg.n_hybrid_sites * cfg.hybrid_attn_every
        for i in range(cfg.n_layers):
            layers.append(("mamba", i == 0, 3 if i < seg else 2))
            if cfg.family == "hybrid" and (i + 1) % cfg.hybrid_attn_every \
                    == 0 and i < seg:
                layers.append(("dense", False, 2))
    else:
        layers += [("dense", i == 0, 2) for i in range(cfg.n_layers)]
    ar, ag, rs = 1 + 2 + 1 + 1 + 1 + 1, int(seq_shard), 0
    for kind, first, runs in layers:
        a, g, r = _layer_calls(kind, first, seq_shard, runs)
        ar, ag, rs = ar + a, ag + g, rs + r
    return {"all_reduce": ar, "all_gather": ag, "reduce_scatter": rs}


def predicted_decode_collectives(cfg) -> dict:
    """Collective calls of one decode step a rank of a dense or MoE model
    whose KV cache ``cache_specs`` shards along its sequence (the model
    axis does not divide the KV heads; a data axis of one rank), from the
    layout table of ``models/attention.py``: a layer's q, k and v column
    shards gathered to whole heads (3 all-gathers), the partial softmaxes'
    MAX and SUM all-reduces (``parallel.combine_softmax``), the row-sharded
    o's and the MLP's (down's, or the experts' sum) all-reduce; once a
    step the vocab-parallel embedding's all-reduce and the head's gather of
    the whole vocab."""
    L = cfg.n_layers
    return {"all_reduce": 1 + 4 * L, "all_gather": 1 + 3 * L,
            "reduce_scatter": 0}


def _rel_fro(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _sharded_rank(rank: int, work: str) -> None:
    """One rank of the ``train_sharded`` phase (4 ranks on ``cuda:0`` over
    gloo, a (data 2, model 2) mesh): each family of the inputs
    (:func:`_family_rank`, ``ef_psum_int8`` on the families of
    ``SHARDED_EF``), then OLMoE-1B-7B's expert-parallel steps
    (:func:`_moe_rank`) where the inputs hold them.  Writes
    ``rank<r>.json`` and, on rank 0, the gathered tensors ``rank0.pt``."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh, pcontext_for
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    dev = torch.device(inp["device"])
    mesh = make_local_mesh(*SHARDED_MESH, device_type=dev.type)
    pctx = pcontext_for(mesh)
    out: dict = {"rank": rank, "coords": [mesh.get_local_rank("data"),
                                          mesh.get_local_rank("model")],
                 "families": {}}
    keep: dict = {}
    for arch, fin in inp["families"].items():
        out["families"][arch], keep[arch] = _family_rank(
            torch, dev, work, arch, fin, mesh, pctx)
    if inp.get("moe") is not None:
        out["moe"] = _moe_rank(dev, work, inp["moe"], mesh, pctx)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        torch.save(keep, work / "rank0.pt")


def _ef_check(torch, share: dict, grads: dict, mesh) -> dict:
    """``ef_psum_int8`` over "data" of a rank's share of step 1's LoRA
    gradients against their exact mean (``grads``, the share summed over
    "data"): the worst synced error and residual in LSBs of the largest
    share entry (the JAX test's bounds: 2 and 1)."""
    import torch.distributed as dist
    from repro_torch.models import parallel
    from repro_torch.optim import ef_psum_int8, tree_map
    from repro_torch.utils import tree_paths
    dgroup = parallel.axis_group(mesh, "data")
    lora = {k: v for k, v in tree_paths(share).items() if v.numel()}
    synced, res = ef_psum_int8(lora, tree_map(torch.zeros_like, lora),
                               dgroup)
    exact = tree_paths(grads)
    worst = {"err_lsb": 0.0, "res_lsb": 0.0, "leaves": len(lora)}
    for k, g in lora.items():
        lsb = parallel.all_reduce_sum(
            g.float().abs().max().reshape(1), dgroup,
            op=dist.ReduceOp.MAX)[0] / 127
        mean = exact[k].float() / parallel.axis_size(mesh, "data")
        worst["err_lsb"] = max(worst["err_lsb"], float(
            (synced[k] - mean).abs().max() / lsb))
        worst["res_lsb"] = max(worst["res_lsb"], float(
            res[k].abs().max() / lsb))
    return worst


def _moe_rank(dev, work: Path, inp: dict, mesh, pctx) -> dict:
    """OLMoE-1B-7B's side of :func:`_sharded_rank`: the parent's state
    restored expert-parallel (experts over "model"), ``SHARDED_MOE_STEPS``
    steps at ``SHARDED_MOE_CF``, then the dropped share of one forward at
    the config's own capacity factor, summed over the ranks."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.pipeline import quantized_param_shapes
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import moe, parallel
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim import merge_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mcfg, mocfg = inp["cfg"], inp["ocfg"]
    c8 = dataclasses.replace(mcfg, capacity_factor=SHARDED_MOE_CF)
    shapes = steps.build_state(quantized_param_shapes(c8), mocfg)
    state, _ = ckpt.restore_tree(
        str(work / "moe_state"), device=dev,
        shardings=steps.named(steps.state_pspecs(shapes, mesh), mesh))
    step = steps.make_train_step(c8, mocfg, pctx)
    mo: dict = {"metrics": [], "launches": [], "step_s": [],
                "collectives": []}
    for b in inp["batches"]:
        parallel.reset_collective_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        mo["step_s"].append(time.perf_counter() - t0)
        mo["metrics"].append({k: float(v) for k, v in m.items()})
        mo["launches"].append(ops.launch_counts())
        mo["collectives"].append(parallel.collective_stats())
    mo["local_experts"] = int(parallel.local_of(
        state["frozen"]["blocks"]["moe"]["gate"]["qcodes"]).shape[1])
    b = inp["batches"][0]
    batch = {k: v.to(dev) for k, v in shard_batch(
        b, steps.batch_pspecs(mcfg, b, pctx.data_axes), mesh).items()}
    with torch.no_grad(), moe.record_drops() as drops:
        loss_fn(merge_params(state["train"], state["frozen"]), mcfg, batch,
                pctx=pctx)
    tot = torch.stack([sum(d for d, _ in drops), sum(n for _, n in drops)]
                      ).double()
    dist.all_reduce(tot)
    mo["dropped_own_cf"] = [float(tot[0]), float(tot[1])]
    mo["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return mo


def _sharded_reference(torch, dev, work: Path,
                       families: tuple = SHARDED_FAMILIES, moe: bool = True,
                       dtype=None) -> dict:
    """The parent's side: each of ``families`` (:func:`_family_reference`,
    in ``dtype`` if given), then OLMoE-1B-7B (:func:`_moe_reference`) with
    ``moe``.  Writes the ranks' ``inputs.pt``."""
    ref: dict = {"families": {}}
    inputs: dict = {"families": {}, "moe": None}
    for arch, layers, method in families:
        ref["families"][arch], inputs["families"][arch] = \
            _family_reference(torch, dev, work, arch, layers, method, dtype)
    if moe:
        ref["moe"], inputs["moe"] = _moe_reference(torch, dev, work)
    torch.save({"device": str(dev), **inputs}, work / "inputs.pt")
    return ref


def _moe_reference(torch, dev, work: Path) -> tuple[dict, dict]:
    """OLMoE-1B-7B at full width, ``SHARDED_MOE_LAYERS`` layers, quantized
    by RTN (the batched engine, no calibration) and saved as a train
    state; ``SHARDED_MOE_STEPS`` unsharded steps at ``SHARDED_MOE_CF`` and
    the dropped share of one forward at its own capacity factor.  Returns
    (the reference, the ranks' inputs)."""
    import dataclasses
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models.modules import QSpec
    from repro_torch.models.parallel import LOCAL
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.optim import OptConfig, merge_params
    cfg = get_config("olmoe-1b-7b", n_layers=SHARDED_MOE_LAYERS)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                    global_batch=8, seed=0))
    t0 = time.perf_counter()
    qp, mcfg, _ = quantize_model(
        init_params(cfg, seed=0, device=dev), cfg, [], engine="batched",
        recipe=QuantRecipe.single("rtn", QSpec(**SHARDED_QSPEC)))
    torch.cuda.synchronize()
    ref: dict = {"quantize_s": time.perf_counter() - t0}
    mcfg = dataclasses.replace(mcfg, quant=dataclasses.replace(
        mcfg.quant, use_kernel=True))
    batches = [stream.next_batch() for _ in range(SHARDED_MOE_STEPS)]
    mocfg = OptConfig(lr=SHARDED_LR, trainable="lora",
                      total_steps=SHARDED_MOE_STEPS, schedule="const")
    state = steps.build_state(qp, mocfg)
    del qp
    ckpt.save_tree(state, str(work / "moe_state"), 1)
    step = steps.make_train_step(dataclasses.replace(
        mcfg, capacity_factor=SHARDED_MOE_CF), mocfg, LOCAL)
    ref["losses"] = []
    for b in batches:
        state, m = step(state, b)
        ref["losses"].append(float(m["loss"]))
    with torch.no_grad(), moe.record_drops() as drops:
        loss_fn(merge_params(state["train"], state["frozen"]), mcfg,
                {k: v.to(dev) for k, v in batches[0].items()})
    ref["dropped_own_cf"] = [float(sum(d for d, _ in drops)),
                             float(sum(n for _, n in drops))]
    del state
    torch.cuda.empty_cache()
    return ref, {"cfg": mcfg, "ocfg": mocfg, "batches": batches}


def _family_config(arch: str, layers: int, dtype=None):
    from repro_torch.configs import get_config
    kw = {"n_layers": layers}
    if dtype is not None:
        kw["dtype"] = dtype
    if arch == "seamless-m4t-medium":
        kw["n_enc_layers"] = layers
    return get_config(arch, **kw)


def _family_reference(torch, dev, work: Path, arch: str, layers: int,
                      method: str, dtype=None) -> tuple[dict, dict]:
    """The parent's side of one of ``SHARDED_FAMILIES``: the model at full
    width quantized (CLoQ over one calibration batch of 8 x 128, or RTN
    with none; the batched engine, 4/64/64) and saved as a train state;
    ``SHARDED_FAMILY_STEPS`` steps at 8 x 128 (the train CLI's data: 32
    encoder frames, 256 patches) unsharded, the gradients at the held
    step, the trained params saved and decoded (the kernels; seamless
    over its encoder's output of seeded frames).  ``dtype``: the model's,
    if not the config's.  Returns (its reference, the ranks' inputs)."""
    import dataclasses
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.data.pipeline import data_kind
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.modules import QSpec
    from repro_torch.models.parallel import LOCAL
    from repro_torch.models.transformer import (encode, init_decode_cache,
                                                init_params)
    from repro_torch.optim import OptConfig, merge_params
    from repro_torch.utils import tree_paths
    cfg = _family_config(arch, layers, dtype)
    stream = TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0,
        kind=data_kind(cfg), enc_len=128 // 4, n_prefix=cfg.n_prefix,
        d_model=cfg.d_model))
    calib = [stream.next_batch()] if method == "cloq" else []
    t0 = time.perf_counter()
    qp, qcfg, _ = quantize_model(
        init_params(cfg, seed=0, device=dev), cfg, calib, engine="batched",
        recipe=QuantRecipe.single(method, QSpec(**SHARDED_QSPEC)))
    torch.cuda.synchronize()
    ref: dict = {"quantize_s": time.perf_counter() - t0, "layers": layers,
                 "method": method}
    cfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    batches = [stream.next_batch() for _ in range(SHARDED_FAMILY_STEPS)]
    ocfg = OptConfig(lr=SHARDED_LR, trainable="lora",
                     total_steps=SHARDED_FAMILY_STEPS, schedule="const")
    grad_at = 1 if method == "rtn" else 0
    state = steps.build_state(qp, ocfg)
    del qp
    ckpt.save_tree(state, str(work / arch / "state"), 1)
    step = steps.make_train_step(cfg, ocfg, LOCAL)
    ref["metrics"], ref["step_s"] = [], []
    for i, b in enumerate(batches):
        if i == grad_at:
            if i:           # the frozen base is state's: the train leaves
                ckpt.save_tree(state["train"],
                               str(work / arch / "grad_train"), 1)
            _, g = steps.value_and_grad(cfg, LOCAL, state, b)
            ref["grads"] = {k: v.detach().cpu()
                            for k, v in tree_paths(g).items()}
            del g
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ref["step_s"].append(time.perf_counter() - t0)
        ref["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            ref["leaves"] = {k: v.detach().cpu() for k, v in
                             tree_paths(state["train"]).items()}
    ckpt.save_tree(state["train"], str(work / arch / "trained"), 1)
    trained = merge_params(state["train"], state["frozen"])
    B, n_tok, T = SHARDED_DECODE
    cache = init_decode_cache(cfg, B, T, device=dev)
    emb = None
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        emb = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
        with torch.no_grad():
            cache["enc_out"].copy_(encode(trained, cfg, emb))
    dec = steps.make_decode_step(cfg, LOCAL)
    tok = torch.tensor([[3], [17], [101], [400]], device=dev)
    tokens, logits = [], []
    ops.reset_launch_counts()
    with torch.no_grad():
        for _ in range(n_tok):
            tokens.append(tok.cpu())
            lg, cache = dec(trained, cache, tok)
            logits.append(lg.float().cpu())
            tok = lg.argmax(-1, keepdim=True)
    ref["decode_launches"] = ops.launch_counts()
    ref["decode_logits"] = torch.stack(logits)
    ref["cfg"] = cfg
    del state, trained, cache
    torch.cuda.empty_cache()
    return ref, {"cfg": cfg, "ocfg": ocfg, "batches": batches,
                 "grad_at": grad_at, "decode_tokens": tokens,
                 "enc_embeds": None if emb is None else emb.cpu(),
                 "ef": arch in SHARDED_EF}


def _family_rank(torch, dev, work: Path, arch: str, inp: dict, mesh,
                 pctx) -> tuple[dict, dict]:
    """One rank's side of one of ``SHARDED_FAMILIES``: the parent's state
    restored as the mesh's DTensors, the routes on its shards, the
    gradients at the held step (the rank's share summed over "data"),
    ``SHARDED_FAMILY_STEPS`` steps with and without ``seq_shard``
    (metrics, collectives, launches, the leaves after step 1), then the
    sharded decode of the parent's trained params fed the parent's
    tokens (seamless's ``enc_out`` rows from the sharded encoder over
    the same frames); with ``ef`` in its inputs, ``ef_psum_int8`` of the
    rank's share of the held gradients (:func:`_ef_check`).  Returns (its
    JSON record, the gathered tensors rank 0 keeps)."""
    import dataclasses
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.pipeline import quantized_param_shapes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import param_specs
    from repro_torch.models import parallel
    from repro_torch.models.transformer import encode, init_decode_cache
    from repro_torch.optim import merge_params
    from repro_torch.utils import tree_paths
    cfg, ocfg = inp["cfg"], inp["ocfg"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    shapes = steps.build_state(quantized_param_shapes(cfg), ocfg)
    named = steps.named(steps.state_pspecs(shapes, mesh), mesh)
    train_named = steps.named(param_specs(shapes["train"], mesh), mesh)

    def restore(name, shardings=named):
        return ckpt.restore_tree(str(work / arch / name), device=dev,
                                 shardings=shardings)[0]

    def gathered(tree):
        return {k: v.detach().cpu() for k, v in
                tree_paths(parallel.gather_tree(tree)).items()}

    t0 = time.perf_counter()
    state0 = restore("state")
    out: dict = {"restore_s": time.perf_counter() - t0, "runs": {}}
    out["routes"] = _kernel_routes(torch, dev, parallel.localize(
        merge_params(state0["train"], state0["frozen"])), cfg, SHARDED_MESH)
    keep: dict = {}
    at = inp["grad_at"]
    g_state = (dict(state0, train=restore("grad_train", train_named)) if at
               else state0)
    _, share = steps.value_and_grad(cfg, pctx, g_state, inp["batches"][at],
                                    sync=False)
    grads = steps.sum_over_data(share, pctx)
    if inp.get("ef"):
        out["ef"] = _ef_check(torch, share, grads, mesh)
    keep["grads"] = gathered(parallel.delocalize(
        grads, parallel.localize(g_state)["train"]))
    del g_state, grads, share
    for seq in (False, True):
        c = dataclasses.replace(cfg, seq_shard=seq)
        state = state0
        step = steps.make_train_step(c, ocfg, pctx)
        run = {"metrics": [], "collectives": [], "launches": [],
               "step_s": []}
        for i, b in enumerate(inp["batches"]):
            parallel.reset_collective_stats()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            run["step_s"].append(time.perf_counter() - t0)
            run["metrics"].append({k: float(v) for k, v in m.items()})
            run["collectives"].append(parallel.collective_stats())
            run["launches"].append(ops.launch_counts())
            if i == 0:
                keep[f"leaves.{int(seq)}"] = gathered(state["train"])
        out["runs"]["seq" if seq else "tp"] = run
        del state
    trained = restore("trained", train_named)
    params = merge_params(trained, state0["frozen"])
    B, _, T = SHARDED_DECODE
    cache = init_decode_cache(cfg, B, T, device=dev, pctx=pctx)
    if inp["enc_embeds"] is not None:
        rows = inp["enc_embeds"].chunk(SHARDED_MESH[0])[
            mesh.get_local_rank("data")].to(dev)
        with torch.no_grad():
            parallel.local_of(cache["enc_out"]).copy_(
                encode(params, cfg, rows, pctx=pctx))
    dec = steps.make_decode_step(cfg, pctx)
    ops.reset_launch_counts()
    parallel.reset_collective_stats()
    logits = []
    with torch.no_grad():
        for tok in inp["decode_tokens"]:
            lg, cache = dec(params, cache, tok.to(dev))
            logits.append(lg.float().cpu())
    out["decode"] = {"launches": ops.launch_counts(),
                     "collectives": parallel.collective_stats(),
                     "cache_local": {k: list(parallel.local_of(v).shape)
                                     for k, v in cache.items()
                                     if k in ("k", "state", "conv_x")}}
    keep["decode_logits"] = torch.stack(logits)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, trained, cache, state0
    return out, keep


def _hold_family(torch, arch: str, ref: dict, ranks: list, got: dict,
                 failed: list) -> dict:
    """One of ``SHARDED_FAMILIES``' rank records and rank 0's gathered
    tensors against the parent's reference, ``train_sharded``'s checks
    (failures appended to ``failed``)."""
    cfg = ref["cfg"]
    r0 = ranks[0]["families"][arch]
    out: dict = {"layers": ref["layers"], "method": ref["method"],
                 "quantize_s": ref["quantize_s"],
                 "unsharded_step_s": ref["step_s"],
                 "restore_s": [r["families"][arch]["restore_s"]
                               for r in ranks],
                 "peak_gb": [r["families"][arch]["peak_gb"] for r in ranks],
                 "routes": r0["routes"]}
    want = [m["loss"] for m in ref["metrics"]]
    for name, run in r0["runs"].items():
        losses = [m["loss"] for m in run["metrics"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        norm = abs(run["metrics"][0]["grad_norm"] -
                   ref["metrics"][0]["grad_norm"]) / \
            ref["metrics"][0]["grad_norm"]
        same = all(r["families"][arch]["runs"][name]["metrics"] ==
                   run["metrics"] for r in ranks)
        pred = predicted_collectives(cfg, name == "seq")
        calls = [{k: c[k]["calls"] for k in pred}
                 for c in run["collectives"]]
        fused = [lc.get("dequant_matmul_lora", 0) for lc in run["launches"]]
        out[name] = {"losses": losses, "unsharded": want, "loss_rel": rel,
                     "grad_norm_rel": norm, "equal_on_ranks": same,
                     "step_s": run["step_s"],
                     "collectives": run["collectives"][-1],
                     "predicted_calls": pred, "fused_a_step": fused}
        if not rel <= LOSS_LIMIT:
            failed.append([arch, name, "loss", rel])
        if not norm <= SHARDED_NORM_REL:
            failed.append([arch, name, "grad_norm", norm])
        if not same:
            failed.append([arch, name, "metrics differ between ranks"])
        if any(c != pred for c in calls):
            failed.append([arch, name, "collectives", calls, pred])
        if any(f != fused_a_step(cfg) for f in fused):
            failed.append([arch, name, "fused launches a step", fused,
                           fused_a_step(cfg)])
    grads = {}
    for k, w in ref["grads"].items():
        if w.numel():
            grads[k] = _rel_fro(torch, got["grads"][k], w)
            if not grads[k] <= SHARDED_GRAD_REL:
                failed.append([arch, "grad", k, grads[k]])
    worst_leaf = (0.0, "")
    for seq in (0, 1):
        for k, w in ref["leaves"].items():
            if not w.numel():
                continue
            d = float((got[f"leaves.{seq}"][k].float() - w.float()).abs()
                      .max())
            lim = 2 * SHARDED_LR + 2.0 ** -7 * float(w.float().abs().max())
            worst_leaf = max(worst_leaf, (d / lim, k))
            if not d <= lim:
                failed.append([arch, "leaf", seq, k, d, lim])
    if "ef" in r0:
        out["ef"] = r0["ef"]
        if not (r0["ef"]["err_lsb"] <= 2 and r0["ef"]["res_lsb"] <= 1):
            failed.append([arch, "ef_psum_int8", r0["ef"]])
    worst = max(grads, key=grads.get)
    out.update(grads_worst=grads[worst], grads_worst_leaf=worst,
               grads_leaves=len(grads), leaves_worst=worst_leaf[0],
               leaves_worst_leaf=worst_leaf[1])
    n_tok = SHARDED_DECODE[1]
    launches = r0["decode"]["launches"]
    calls = sum(launches.values()) / n_tok
    err = float((got["decode_logits"] - ref["decode_logits"]).abs().max())
    scale = float(ref["decode_logits"].abs().max())
    lim = logits_limit(scale, calls)
    out["decode"] = {"max_abs_err": err, "max_abs_logit": scale,
                     "limit": lim, "launches": launches,
                     "unsharded_launches": ref["decode_launches"],
                     "collectives": r0["decode"]["collectives"],
                     "cache_local": r0["decode"]["cache_local"]}
    if not err <= lim:
        failed.append([arch, "decode", err, lim])
    attention = cfg.family in ("dense", "encdec")
    if launches != ref["decode_launches"] or \
            launches.get("dequant_matmul", 0) < 1 or \
            (launches.get("flash_attention", 0) < 1) == attention:
        failed.append([arch, "decode launches", launches,
                       ref["decode_launches"]])
    return out


def _hold_moe(torch, ref: dict, ranks: list, failed: list) -> dict:
    """OLMoE-1B-7B's expert-parallel rank records against the parent's
    reference: its losses within ``LOSS_LIMIT`` (failures appended to
    ``failed``), the dropped shares beside each other."""
    mo = ranks[0]["moe"]
    losses = [m["loss"] for m in mo["metrics"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    dropped = mo["dropped_own_cf"]        # summed over the 4 ranks
    out = {"layers": SHARDED_MOE_LAYERS,
           "capacity_factor": SHARDED_MOE_CF, "losses": losses,
           "unsharded": ref["losses"], "loss_rel": rel,
           "local_experts": mo["local_experts"],
           "step_s": mo["step_s"], "collectives": mo["collectives"][-1],
           "launches_a_step": mo["launches"][-1],
           "quantize_s": ref["quantize_s"],
           "dropped_share_own_cf": {
               "sharded": dropped[0] / dropped[1],
               "unsharded": ref["dropped_own_cf"][0]
               / ref["dropped_own_cf"][1]},
           "peak_gb": [r["moe"]["peak_gb"] for r in ranks]}
    if not rel <= LOSS_LIMIT:
        failed.append(["moe", "loss", rel])
    if not all(lc.get("dequant_matmul_lora", 0) >= 1
               for lc in mo["launches"]):
        failed.append(["moe", "launches", mo["launches"]])
    return out


def _seq_kv_reference(torch, dev, work: Path, dtype=None) -> dict:
    """The parent's side of ``seq_kv``: ``SEQ_KV_ARCH`` at full width,
    ``SEQ_KV_LAYERS`` layer, quantized by RTN 4/64/64 (the batched engine,
    no calibration), its params saved, and its unsharded kernel decode of
    ``SEQ_KV_DECODE``'s greedy tokens from position 0, written for the
    ranks to ``seq_kv_inputs.pt``; the model in ``dtype`` (default
    ``SEQ_KV_DTYPE``).  Returns the reference."""
    import dataclasses
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.modules import QSpec
    from repro_torch.models.parallel import LOCAL
    from repro_torch.models.transformer import init_decode_cache, init_params
    cfg = get_config(SEQ_KV_ARCH, n_layers=SEQ_KV_LAYERS,
                     dtype=dtype or getattr(torch, SEQ_KV_DTYPE))
    t0 = time.perf_counter()
    qp, qcfg, _ = quantize_model(
        init_params(cfg, seed=0, device=dev), cfg, [], engine="batched",
        recipe=QuantRecipe.single("rtn", QSpec(**SHARDED_QSPEC)))
    torch.cuda.synchronize()
    ref: dict = {"quantize_s": time.perf_counter() - t0}
    qcfg = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, use_kernel=True))
    ckpt.save_tree(qp, str(work / "seq_kv_params"), 1)
    B, n_tok, T = SEQ_KV_DECODE
    cache = init_decode_cache(qcfg, B, T, device=dev)
    dec = steps.make_decode_step(qcfg, LOCAL)
    tok = torch.tensor([[3], [17], [101], [400]], device=dev)
    tokens, logits = [], []
    ops.reset_launch_counts()
    with torch.no_grad():
        for _ in range(n_tok):
            tokens.append(tok.cpu())
            lg, cache = dec(qp, cache, tok)
            logits.append(lg.float().cpu())
            tok = lg.argmax(-1, keepdim=True)
    ref.update(launches=ops.launch_counts(), logits=torch.stack(logits),
               cfg=qcfg)
    del qp, cache
    torch.cuda.empty_cache()
    torch.save({"device": str(dev), "cfg": qcfg, "tokens": tokens},
               work / "seq_kv_inputs.pt")
    return ref


def _seq_kv_rank(rank: int, work: str) -> None:
    """One rank of ``seq_kv`` (8 ranks on ``cuda:0`` over gloo, a (data
    1, model 8) mesh): the parent's params restored by ``param_specs``,
    the cache by ``init_decode_cache(pctx=)`` (``cache_specs`` shards its
    sequence), then the parent's tokens decoded, each step's collectives,
    launches and seconds recorded.  Writes ``seq_kv_rank<r>.json`` and,
    on rank 0, the logits ``seq_kv_rank0.pt``."""
    import hashlib

    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.pipeline import quantized_param_shapes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh, pcontext_for
    from repro_torch.launch.shardings import param_specs
    from repro_torch.models import parallel
    from repro_torch.models.transformer import init_decode_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    inp = torch.load(work / "seq_kv_inputs.pt", weights_only=False)
    dev = torch.device(inp["device"])
    mesh = make_local_mesh(*SEQ_KV_MESH, device_type=dev.type)
    pctx = pcontext_for(mesh)
    cfg = inp["cfg"]
    torch.cuda.reset_peak_memory_stats(dev)
    shapes = quantized_param_shapes(cfg)
    params, _ = ckpt.restore_tree(
        str(work / "seq_kv_params"), device=dev,
        shardings=steps.named(param_specs(shapes, mesh), mesh))
    B, _, T = SEQ_KV_DECODE
    cache = init_decode_cache(cfg, B, T, device=dev, pctx=pctx)
    dec = steps.make_decode_step(cfg, pctx)
    out: dict = {"rank": rank, "collectives": [], "launches": [],
                 "step_s": []}
    logits = []
    with torch.no_grad():
        for tok in inp["tokens"]:
            parallel.reset_collective_stats()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = dec(params, cache, tok.to(dev))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["collectives"].append(parallel.collective_stats())
            out["launches"].append(ops.launch_counts())
            logits.append(lg.float().cpu())
    k = cache["k"]
    out.update(cache_local=list(parallel.local_of(k).shape),
               cache_layout=list(parallel.spec_of_placements(
                   k.placements, k.device_mesh, k.dim())),
               digest=hashlib.sha1(torch.stack(logits).numpy().tobytes())
               .hexdigest(),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    (work / f"seq_kv_rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        torch.save(torch.stack(logits), work / "seq_kv_rank0.pt")


def _hold_seq_kv(torch, ref: dict, ranks: list, got, failed: list) -> dict:
    """``seq_kv``'s rank records against the parent's unsharded kernel
    decode: the logits within ``logits_limit``, the same on every rank;
    the cache's sequence over "model"; every rank's every step launching
    the partial ``flash_attention`` and ``dequant_matmul`` as often as the
    unsharded step does; its collectives ``predicted_decode_collectives``
    (failures appended to ``failed``)."""
    cfg = ref["cfg"]
    n_tok = SEQ_KV_DECODE[1]
    want_launch = {k: v // n_tok for k, v in ref["launches"].items()}
    calls = sum(ref["launches"].values()) / n_tok
    step_err = (got - ref["logits"]).abs().amax(dim=(1, 2))
    err = float(step_err.max())
    scale = float(ref["logits"].abs().max())
    lim = logits_limit(scale, calls)
    pred = predicted_decode_collectives(cfg)
    r0 = ranks[0]
    out = {"arch": SEQ_KV_ARCH, "layers": SEQ_KV_LAYERS,
           "dtype": str(cfg.dtype).split(".")[-1],
           "step_err": [float(e) for e in step_err],
           "mesh": {"data": SEQ_KV_MESH[0], "model": SEQ_KV_MESH[1]},
           "decode": list(SEQ_KV_DECODE), "quantize_s": ref["quantize_s"],
           "max_abs_err": err, "max_abs_logit": scale, "limit": lim,
           "cache_local": r0["cache_local"],
           "cache_layout": r0["cache_layout"],
           "collectives_a_step": r0["collectives"][-1],
           "predicted_calls": pred, "launches_a_step": r0["launches"][-1],
           "unsharded_launches_a_step": want_launch,
           "step_s": [min(r["step_s"]) for r in ranks],
           "step_s_median_rank0": sorted(r0["step_s"])[n_tok // 2],
           "peak_gb": [r["peak_gb"] for r in ranks]}
    if not err <= lim:
        failed.append(["seq_kv", "decode", err, lim])
    if len({r["digest"] for r in ranks}) != 1:
        failed.append(["seq_kv", "logits differ between ranks"])
    if r0["cache_layout"][2] != "model":
        failed.append(["seq_kv", "cache not sequence-sharded",
                       r0["cache_layout"]])
    for r in ranks:
        for i, (lc, cc) in enumerate(zip(r["launches"], r["collectives"])):
            if lc != want_launch or lc.get("flash_attention", 0) < 1 or \
                    lc.get("dequant_matmul", 0) < 1:
                failed.append(["seq_kv", "launches", r["rank"], i, lc,
                               want_launch])
                break
            calls_i = {k: cc[k]["calls"] for k in pred}
            if calls_i != pred:
                failed.append(["seq_kv", "collectives", r["rank"], i,
                               calls_i, pred])
                break
    out["launches"] = {k: sum(sum(lc.get(k, 0) for lc in r["launches"])
                              for r in ranks)
                       for k in ("gram", "dequant_matmul_lora",
                                 "dequant_matmul", "flash_attention")}
    return out


def train_sharded_phase(torch, dev, work: Path = SHARDED_DIR,
                        hold: bool = True,
                        families: tuple = SHARDED_FAMILIES,
                        moe: bool = True, seq_kv: bool = True,
                        dtype=None, seq_kv_dtype=None) -> dict:
    """The sharded fine-tuning step and decode on a (data 2, model 2) mesh
    of 4 gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on one
    device): :func:`_sharded_reference` in this process, then
    :func:`_sharded_rank` in the ranks.  Held for each of ``families``
    (:func:`_hold_family`): each step's loss within ``LOSS_LIMIT`` of the
    unsharded one, with and without ``seq_shard``; the held step's
    gradient norm within ``SHARDED_NORM_REL`` and every gathered LoRA
    gradient within ``SHARDED_GRAD_REL`` (relative Frobenius, an RTN
    model's at step 2); the leaves after step 1 within 2 x lr + one bf16
    ulp (2^-7 of the largest) of the unsharded (AdamW's first step moves
    an element by lr x sign(g), each side rounds to bf16); the metrics
    equal on every rank; the collectives a step
    :func:`predicted_collectives`; the fused kernel launched
    :func:`fused_a_step` times a step; the decode's logits within
    ``logits_limit`` of the unsharded kernel decode fed the same tokens
    (its greedy ones: a near-tie must not fork the two), its launches a
    rank those of the unsharded decode; for ``SHARDED_EF``,
    ``ef_psum_int8`` within 2 LSB of the exact mean and its residual
    within 1 LSB (the JAX test's bounds).  With ``moe``, OLMoE's
    expert-parallel losses within ``LOSS_LIMIT`` of the unsharded port
    (:func:`_hold_moe`).  With ``seq_kv``, the sequence-sharded decode on
    8 more ranks, a (data 1, model 8) mesh (:func:`_hold_seq_kv`).  No
    speed-up is measurable: the ranks share one card and talk through the
    host.  ``work``: the directory of the checkpoints and the ranks'
    files; ``hold=False`` returns the failures in ``failed`` instead of
    raising (``chip_fault_check.py``); ``dtype``: the families' dtype if
    not their configs' (``--families``, ``--family-dtype``);
    ``seq_kv_dtype``: seq_kv's if not ``SEQ_KV_DTYPE``
    (``--seq-kv-dtype``)."""
    import shutil
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    failed: list = []
    out: dict = {"mesh": {"data": SHARDED_MESH[0], "model": SHARDED_MESH[1]},
                 "backend": "gloo", "families": {}}
    kernels = ("gram", "dequant_matmul_lora", "dequant_matmul",
               "flash_attention")
    out["launches"] = dict.fromkeys(kernels, 0)
    if families or moe:
        ref = _sharded_reference(torch, dev, work, families, moe, dtype)
        t_ranks = time.perf_counter()
        n_ranks = SHARDED_MESH[0] * SHARDED_MESH[1]
        spawn_ranks(_sharded_rank, n_ranks, backend="gloo", device=dev.type,
                    args=(str(work),), store_dir=str(work))
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(n_ranks)]
        got = torch.load(work / "rank0.pt")
        out.update(device=f"cuda:0 (all {n_ranks} ranks)",
                   ranks_s=time.perf_counter() - t_ranks,
                   reference_s=t_ranks - t_phase)
        out["families"] = {arch: _hold_family(torch, arch, fr, ranks,
                                              got[arch], failed)
                           for arch, fr in ref["families"].items()}
        for k in kernels:
            out["launches"][k] += sum(
                sum(lc.get(k, 0) for n in ("tp", "seq")
                    for lc in r["families"][a]["runs"][n]["launches"])
                + r["families"][a]["decode"]["launches"].get(k, 0)
                for r in ranks for a in r["families"])
        if moe:
            out["moe"] = _hold_moe(torch, ref["moe"], ranks, failed)
            for k in kernels:
                out["launches"][k] += sum(lc.get(k, 0) for r in ranks
                                          for lc in r["moe"]["launches"])
    if seq_kv:
        t0 = time.perf_counter()
        sref = _seq_kv_reference(torch, dev, work, seq_kv_dtype)
        t1 = time.perf_counter()
        n = SEQ_KV_MESH[0] * SEQ_KV_MESH[1]
        spawn_ranks(_seq_kv_rank, n, backend="gloo", device=dev.type,
                    args=(str(work),), store_dir=str(work))
        sranks = [json.loads((work / f"seq_kv_rank{r}.json").read_text())
                  for r in range(n)]
        out["seq_kv"] = _hold_seq_kv(torch, sref, sranks,
                                     torch.load(work / "seq_kv_rank0.pt"),
                                     failed)
        out["seq_kv"].update(reference_s=t1 - t0,
                             ranks_s=time.perf_counter() - t1,
                             case_s=time.perf_counter() - t0)
        for k in kernels:
            out["launches"][k] += out["seq_kv"]["launches"][k]
    out.update(failed=failed, phase_s=time.perf_counter() - t_phase)
    if failed and hold:
        raise Failed(f"train_sharded: {out}")
    return out


# -- the static gate and the compile cache (slice 17) -------------------------

CACHE_DIR = ROOT / "build" / "chip_smoke" / "compile_cache"
# the serve run of the compile_cache phase: fresh processes, smoke widths
CACHE_SERVE = ("--arch", "qwen3-1.7b", "--smoke", "--requests", "2",
               "--max-new", "8")
# the library the phase cuts to half its bytes in a copy of the cache
CACHE_CUT = "dequant_matmul.cu"
# the kernels that serve run launches (dequant_matmul_lora: rows < 64)
CACHE_PATH_KERNELS = ("gram", "dequant_matmul", "flash_attention")


def purity_item_step():
    """A captured step that reads a tensor to the host: PURITY's finding,
    and a sync that the capturing stream refuses."""
    from repro_torch.launch.steps import CapturedStep

    def step(x):
        return x * x.sum().item()
    return CapturedStep(step)


def purity_clean_step():
    """The same step kept on the device: no finding, a capture that
    replays."""
    from repro_torch.launch.steps import CapturedStep

    def step(x):
        return x * x.sum()
    return CapturedStep(step)


def replay_unsynced(graph) -> float:
    """Seconds of a graph replay by the host clock with no sync: the
    launch only (BENCH's finding)."""
    t0 = time.perf_counter()
    graph.replay()
    return time.perf_counter() - t0


def replay_synced(torch, graph) -> float:
    """Seconds of a graph replay by the host clock, synced before the stop
    timestamp: the work."""
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _rules_flag(fn, rule: str) -> list:
    """Lines (in ``fn``'s source) where the port's ``rule`` flags it."""
    import inspect
    import textwrap

    from repro_torch import analysis
    src = textwrap.dedent(inspect.getsource(fn))
    return [f.line for f in analysis.lint_source(src, f"<{fn.__name__}>")
            if f.rule == rule]


def allocator_recovers(torch, free: int) -> bool:
    """Whether the caching allocator still frees and reuses memory: a
    block of 40% of ``free`` (the card's free bytes before a failed
    capture) is freed with a use on a side stream, then one allocation of
    80% of ``free`` must succeed.  While a capture is left underway the
    allocator defers such a block's end-of-life event for ever, so the
    80% cannot fit beside it."""
    held = torch.empty(int(0.4 * free), dtype=torch.uint8, device="cuda")
    held.record_stream(torch.cuda.Stream())
    del held
    try:
        big = torch.empty(int(0.8 * free), dtype=torch.uint8, device="cuda")
    except RuntimeError:            # out of memory
        return False
    del big
    torch.cuda.empty_cache()
    return True


def purity_capture() -> dict:
    """The ``.item()`` step's capture (its second call) and the clean
    twin's capture and replays, on the card, then whether the failed
    capture gave back the caller's stream and the allocator
    (:func:`allocator_recovers`; ``CapturedStep`` hands back the graph's
    pool, which torch's ``capture_end`` leaves capturing when it raises).
    Run in a process of its own (:func:`_purity_process`), which that
    check needs the card's memory for."""
    import torch
    x = torch.arange(1, 9, dtype=torch.float32, device="cuda")
    good = purity_clean_step()
    outs = [good(x).clone() for _ in range(3)]
    want = x * x.sum()
    bad = purity_item_step()
    bad(x)                                   # the eager first call
    caller = torch.cuda.current_stream()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    try:
        bad(x)                               # the capture
        raised = ""
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:160]
    stream_back = torch.cuda.current_stream() == caller
    return {"item_capture_raised": raised,
            "clean_captured": good.graph is not None,
            "clean_replays_equal": all(bool(torch.equal(o, want))
                                       for o in outs),
            "stream_restored": stream_back,
            "allocator_recovered": stream_back and allocator_recovers(
                torch, free)}


def _purity_process(src: Path) -> subprocess.Popen:
    """:func:`purity_capture` started in a fresh process on the package
    under ``src``; its last line of output is the result as JSON."""
    import os
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as cs; "
         "print(json.dumps(cs.purity_capture()))"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(src),
                                                         str(ROOT)])))


def _bench_case(torch, dev, reps: int = 20) -> dict:
    """One captured Qwen3-1.7B-smoke decode step timed by the host clock
    without a sync and with one, and BENCH's verdicts on both sources."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import CapturedStep, make_decode_step
    from repro_torch.models.parallel import LOCAL
    from repro_torch.models.transformer import init_decode_cache, init_params
    cfg = get_smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device=dev)
    cache = init_decode_cache(cfg, 4, 64, device=dev)
    decode = make_decode_step(cfg, LOCAL)

    def step(inp):
        logits, _ = decode(params, dict(cache, idx=inp[4]), inp[:4, None])
        return logits

    cap = CapturedStep(step)
    inp = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(3):
            cap(inp)
    unsynced, synced = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        unsynced.append(replay_unsynced(cap.graph))
        torch.cuda.synchronize()
        synced.append(replay_synced(torch, cap.graph))
    return {"unsynced_ms": 1e3 * _median(unsynced),
            "synced_ms": 1e3 * _median(synced), "reps": reps,
            "unsynced_flagged_lines": _rules_flag(replay_unsynced, "BENCH"),
            "synced_flagged_lines": _rules_flag(replay_synced, "BENCH")}


def analysis_phase(torch, dev) -> dict:
    """The port's static gate on the card's checkout (the lint of
    ``src/repro_torch`` at gating tier and ``chip_*.py`` at report tier,
    the shape fleet against the JAX package's goldens), then PURITY and
    BENCH held against the card.  Emits the lint and fleet lines; fails on
    a gating finding, a fleet diff, or a rule that disagrees with what the
    card does."""
    import repro_torch
    from repro_torch import analysis
    from repro_torch.analysis import shapes
    t_phase = time.perf_counter()
    pkg = Path(repro_torch.__file__).resolve().parent
    probe = _purity_process(pkg.parent)      # runs beside the lint
    try:
        t0 = time.perf_counter()
        base = analysis.load_baseline(pkg / "analysis" / "baseline.json")
        found = analysis.lint_paths([pkg], root=pkg.parents[1],
                                    tier=analysis.TIER_ERROR, baseline=base)
        gate = analysis.gating(found)
        report = analysis.lint_paths(sorted(ROOT.glob("chip_*.py")),
                                     root=ROOT, tier=analysis.TIER_REPORT)
        emit({"phase": "analysis", "lint": {
            "seconds": time.perf_counter() - t0, "files": len(list(
                pkg.rglob("*.py"))), "gating": len(gate),
            "findings": [f.render() for f in gate][:20],
            "report": analysis.summarize(report)}})
        t0 = time.perf_counter()
        diffs = shapes.run_fleet(ROOT / "tests" / "golden" / "shapes")
        emit({"phase": "analysis", "fleet": {
            "seconds": time.perf_counter() - t0,
            "cells": len(shapes.fleet_cells()), "diffs": len(diffs),
            "first": diffs[:10]}})
        ben = _bench_case(torch, dev)
        out, err = probe.communicate(timeout=600)
        if probe.returncode:
            raise Failed(f"analysis: the PURITY capture's process exited "
                         f"{probe.returncode}:\n{err[-3000:]}")
        pur = {**json.loads(out.splitlines()[-1]),
               "item_flagged_lines": _rules_flag(purity_item_step,
                                                 "PURITY"),
               "clean_flagged_lines": _rules_flag(purity_clean_step,
                                                  "PURITY")}
    finally:
        if probe.poll() is None:
            probe.kill()
            probe.wait()
    failed = []
    if gate:
        failed.append(f"{len(gate)} gating finding(s)")
    if diffs or len(shapes.fleet_cells()) != 30:
        failed.append(f"fleet: {len(diffs)} diff(s)")
    if not (pur["item_capture_raised"] and pur["item_flagged_lines"]):
        failed.append("PURITY: the .item() capture must raise and be "
                      f"flagged ({pur})")
    if not (pur["clean_captured"] and pur["clean_replays_equal"]) or \
            pur["clean_flagged_lines"]:
        failed.append(f"PURITY: the clean twin ({pur})")
    if not pur["allocator_recovered"]:
        failed.append("the failed capture did not hand back the caller's "
                      f"stream and the allocator ({pur})")
    if not ben["unsynced_ms"] < ben["synced_ms"]:
        failed.append(f"BENCH: the unsynced replay is not the shorter "
                      f"({ben})")
    if not ben["unsynced_flagged_lines"] or ben["synced_flagged_lines"]:
        failed.append(f"BENCH: verdicts ({ben})")
    if failed:
        raise Failed("analysis: " + "; ".join(failed))
    return {"purity": pur, "bench": ben,
            "phase_s": time.perf_counter() - t_phase}


def _serve_fields(out: str) -> dict:
    """The ``key=value`` fields of the serve CLI's ``[serve]`` lines."""
    fields = {}
    for ln in out.splitlines():
        if ln.startswith("[serve] "):
            for tok in ln.split()[1:]:
                k, sep, v = tok.partition("=")
                if sep:
                    fields[k] = v
    return fields


def _cached_serve(src: Path, cache: Path, tokens: Path, shim: Path,
                  log: Path) -> dict:
    """One fresh process of the serve CLI on ``cache``, with ``nvcc``
    behind a shim that logs each call.  Returns its fields, seconds,
    tokens, compiles and standard error."""
    import os
    log.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(src),
               PATH=f"{shim}{os.pathsep}{os.environ.get('PATH', '')}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CACHE_SERVE,
         "--compile-cache", str(cache), "--tokens-out", str(tokens)],
        capture_output=True, text=True, env=env, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise Failed(f"compile_cache: serve exited {proc.returncode}:\n"
                     + (proc.stdout + proc.stderr)[-3000:])
    calls = log.read_text().splitlines() if log.exists() else []
    f = _serve_fields(proc.stdout)
    return {"seconds": secs,
            "cache_hits": int(f["cache_hits"]),
            "cache_misses": int(f["cache_misses"]),
            "cache_corrupt": int(f["cache_corrupt"]),
            "cache_unportable": int(f["cache_unportable"]),
            "libraries": f["libraries"].split(","),
            "launches": {k: int(n) for k, _, n in (
                kn.partition(":") for kn in f["launches"].split(",")
                if kn != "none")},
            "rank_buckets": f["rank_buckets"].split(","),
            "nvcc_compiles": sum("--version" not in c for c in calls),
            "warned": "corrupt kernel library" in proc.stderr,
            "tokens": json.loads(tokens.read_text())["outputs"]}


def compile_cache_phase(torch, dev) -> dict:
    """Two fresh serve processes on the build phase's cache directory: the
    warm one loads every library from it (hits, no ``nvcc``, a capture a
    rank bucket as ``unportable``); the second, on a copy with
    ``CACHE_CUT``'s library cut to half its bytes, warns, rebuilds that one
    library (one ``nvcc``) and gives the same tokens."""
    import shutil

    import repro_torch
    from repro_torch.core import compile_cache
    from repro_torch.kernels import build
    t_phase = time.perf_counter()
    src = Path(repro_torch.__file__).resolve().parents[1]
    warm = build.build_dir()
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    shim = CACHE_DIR / "shim"
    shim.mkdir(parents=True)
    log = CACHE_DIR / "nvcc_calls.log"
    (shim / "nvcc").write_text(
        f"#!/bin/sh\necho \"$*\" >> '{log}'\n"
        f"exec '{compile_cache.nvcc_path()}' \"$@\"\n")
    (shim / "nvcc").chmod(0o755)
    first = _cached_serve(src, warm, CACHE_DIR / "tokens_warm.json", shim,
                          log)
    cut = CACHE_DIR / "cut"
    shutil.copytree(warm, cut, ignore=shutil.ignore_patterns("*.tmp*"))
    lib = cut / build.use_cache().path(build.CSRC / CACHE_CUT,
                                       build.NVCC_FLAGS).name
    size = lib.stat().st_size
    with open(lib, "r+b") as f:
        f.truncate(size // 2)
    second = _cached_serve(src, cut, CACHE_DIR / "tokens_cut.json", shim,
                           log)
    failed = []
    if first["cache_misses"] or first["nvcc_compiles"] or \
            first["cache_corrupt"]:
        failed.append("warm: a library was rebuilt")
    if first["cache_hits"] != len(first["libraries"]):
        failed.append("warm: hits are not the libraries loaded")
    if first["cache_unportable"] != len(first["rank_buckets"]):
        failed.append("warm: unportable is not the rank buckets captured")
    for run in (first, second):
        if not all(run["launches"].get(k) for k in CACHE_PATH_KERNELS):
            failed.append(f"a kernel of the serve path never launched: "
                          f"{run['launches']}")
    if (second["cache_corrupt"], second["cache_misses"],
            second["nvcc_compiles"]) != (1, 1, 1):
        failed.append("cut: not one corrupt library rebuilt by one nvcc")
    if second["cache_hits"] != first["cache_hits"] - 1:
        failed.append("cut: hits are not one fewer")
    if not second["warned"]:
        failed.append("cut: no warning")
    if second["tokens"] != first["tokens"]:
        failed.append("cut: tokens differ from the warm run's")
    out = {"warm_dir": str(warm), "cut": {"library": lib.name,
                                          "bytes": size, "kept": size // 2},
           **{name: {k: v for k, v in run.items() if k != "tokens"}
              for name, run in (("warm", first), ("rebuilt", second))},
           "tokens_equal": second["tokens"] == first["tokens"],
           "failed": failed, "phase_s": time.perf_counter() - t_phase}
    if failed:
        raise Failed(f"compile_cache: {'; '.join(failed)}: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served qwen3-1.7b (widths are never "
                         "cut)")
    ap.add_argument("--moe-layers", type=int, default=MOE_LAYERS,
                    help=f"depth of OLMoE-1B-7B in the moe phase "
                         f"({MOE_LAYERS}); any other depth runs the device "
                         "and build phases and the moe phase alone (the "
                         "full-depth check: --moe-layers 16)")
    ap.add_argument("--hybrid-layers", type=int, default=HYBRID_LAYERS,
                    help=f"depth of Zamba2-7B in the ssm phase "
                         f"({HYBRID_LAYERS}, at least 12: two sites); any "
                         "other depth runs the device and build phases and "
                         "the ssm phase alone (the full-depth check: "
                         "--hybrid-layers 81)")
    ap.add_argument("--vlm-layers", type=int, default=VLM_LAYERS,
                    help=f"depth of Pixtral-12B in the encdec phase "
                         f"({VLM_LAYERS}); any other depth runs the device "
                         "and build phases and Pixtral-12B alone by RTN "
                         "(the full-depth check: --vlm-layers 40)")
    ap.add_argument("--only", choices=("analysis", "compile_cache", "kernels",
                                       "lora", "configs", "ssm", "encdec",
                                       "allocate", "levers", "trace",
                                       "distributed", "train_sharded"),
                    help="run the device and build phases and this phase "
                         "alone (a quick check of one path)")
    ap.add_argument("--families", default=None,
                    help="with --only train_sharded: these of "
                         "SHARDED_FAMILIES alone, comma-separated (the "
                         "MoE and seq_kv cases left out)")
    ap.add_argument("--seq-kv-only", action="store_true",
                    help="with --only train_sharded: the sequence-sharded "
                         "decode case (seq_kv) alone")
    ap.add_argument("--seq-kv-dtype", choices=("bfloat16", "float32"),
                    default=None,
                    help=f"with --only train_sharded: seq_kv's model in "
                         f"this dtype ({SEQ_KV_DTYPE})")
    ap.add_argument("--family-dtype", choices=("bfloat16", "float32"),
                    default=None,
                    help="with --only train_sharded: the families' models "
                         "in this dtype (their configs': bfloat16)")
    a = ap.parse_args(argv)
    fams = SHARDED_FAMILIES if a.families is None else tuple(
        f for f in SHARDED_FAMILIES if f[0] in a.families.split(","))
    if a.families is not None and len(fams) != len(a.families.split(",")):
        ap.error(f"--families: each one of "
                 f"{[f[0] for f in SHARDED_FAMILIES]}")
    t_script = time.perf_counter()
    t_lap = [t_script]

    def lap() -> dict:
        """``phase_s``: seconds since the previous phase line."""
        now = time.perf_counter()
        dt, t_lap[0] = now - t_lap[0], now
        return {"phase_s": dt}
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase = "device"
    try:
        card = smi()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": card,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "allow_tf32": {"matmul": False, "cudnn": False}, **lap()})

        phase = "build"
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        logs = build.build_all()
        ptxas = {src: [ln.split(":", 1)[-1].strip()
                       for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "wgmma" in ln]
                 for src, log in logs.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "dir": str(build.build_dir().relative_to(ROOT)),
              "sources": list(build.SOURCES), "ptxas": ptxas, **lap()})

        if a.only:
            phase = a.only
            run = {"analysis": lambda: analysis_phase(torch, dev),
                   "compile_cache": lambda: compile_cache_phase(torch, dev),
                   "kernels": lambda: kernels_phase(torch, dev),
                   "lora": lambda: lora_phase(torch, dev),
                   "configs": lambda: configs_phase(torch, dev),
                   "ssm": lambda: ssm_phase(torch, dev, a.hybrid_layers),
                   "encdec": lambda: encdec_phase(torch, dev, a.vlm_layers),
                   "allocate": lambda: allocate_phase(torch, dev),
                   "levers": lambda: levers_phase(torch, dev),
                   "trace": lambda: trace_phase(torch, dev),
                   "distributed": lambda: distributed_phase(torch, dev),
                   "train_sharded": lambda: train_sharded_phase(
                       torch, dev, families=() if a.seq_kv_only else fams,
                       moe=a.families is None and not a.seq_kv_only,
                       seq_kv=a.families is None,
                       dtype=a.family_dtype and getattr(
                           torch, a.family_dtype),
                       seq_kv_dtype=a.seq_kv_dtype and getattr(
                           torch, a.seq_kv_dtype))
                   }[a.only]
            emit({"phase": a.only, **run(), **lap(),
                  "script_s": time.perf_counter() - t_script})
            print(card, flush=True)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})
            return 0
        if a.moe_layers != MOE_LAYERS or a.hybrid_layers != HYBRID_LAYERS \
                or a.vlm_layers != VLM_LAYERS:
            if a.moe_layers != MOE_LAYERS:
                phase = "moe"
                emit({"phase": "moe", **moe_phase(torch, dev, a.moe_layers),
                      **lap()})
            if a.hybrid_layers != HYBRID_LAYERS:
                phase = "ssm"
                emit({"phase": "ssm",
                      **ssm_phase(torch, dev, a.hybrid_layers), **lap()})
            if a.vlm_layers != VLM_LAYERS:
                phase = "encdec"
                emit({"phase": "encdec",
                      **encdec_phase(torch, dev, a.vlm_layers), **lap(),
                      "script_s": time.perf_counter() - t_script})
            print(card, flush=True)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})
            return 0

        phase = "analysis"
        emit({"phase": "analysis", **analysis_phase(torch, dev), **lap()})
        phase = "compile_cache"
        cc = compile_cache_phase(torch, dev)
        emit({"phase": "compile_cache", **cc, **lap()})

        phase = "kernels"
        dq, dq_cases = check_dequant(torch, dev)
        fa, fa_cases = check_flash(torch, dev)
        fp, fp_cases = check_flash_partial(torch, dev)
        gr, gr_cases = check_gram(torch, dev)
        lo, lo_cases = check_lora(torch, dev)
        dq_t = time_dequant(torch, dev)
        fa_t = time_flash(torch, dev)
        fa_long = time_flash(torch, dev, T=4096, lens=(4096, 3072, 1024, 1))
        fp_t = time_flash_partial(torch, dev)
        gr_t = time_gram(torch, dev)
        lo_t = time_lora(torch, dev)
        emit({"phase": "kernels", "dequant_matmul": {**dq, **dq_t},
              "flash_attention": {**fa, **fa_t},
              "flash_attention_cache_4096": fa_long,
              "flash_attention_partial": {**fp, **fp_t},
              "work": "one 28-layer qwen3-1.7b decode step at batch 4 "
                      "(flash_attention also at a 4096-key cache)", **lap()})
        emit({"phase": "kernels", "dequant_cases": dq_cases,
              "fields": ["M", "K", "N", "bits", "g", "dtype", "route",
                         "max_abs_err", "any_zero"], **lap()})
        emit({"phase": "kernels", "flash_cases": fa_cases,
              "fields": ["B", "Hq", "Hkv", "Sq", "Sk", "d", "causal", "dtype",
                         "route", "max_abs_err", "max_abs_ref"], **lap()})
        emit({"phase": "kernels", "flash_partial_cases": fp_cases,
              "fields": ["B", "Hq", "Hkv", "Sk", "d", "dtype", "route",
                         "max_abs_err", "lse_err", "zero_rows"], **lap()})
        emit({"phase": "dequant_splits", **time_dequant_splits(torch, dev),
              **lap()})
        emit({"phase": "kernels", "gram_cases": gr_cases,
              "fields": ["T", "D", "dtype", "route", "max_abs_err",
                         "max_abs_ref", "within_f32_tol"], **lap()})
        emit({"phase": "gram_tiles", **time_gram_tiles(torch, dev), **lap()})
        emit({"phase": "kernels", "gram": {**gr, **gr_t},
              "dequant_matmul_lora": {**lo, **lo_t},
              "work": "one 28-layer qwen3-1.7b calibration batch (gram) "
                      "and training forward (dequant_matmul_lora) at batch "
                      "8 x 128", **lap()})
        emit({"phase": "kernels", "lora_cases": lo_cases,
              "fields": ["M", "K", "N", "bits", "g", "r", "dtype", "route",
                         "max_abs_err", "w_std"], **lap()})
        emit({"phase": "lora_precision", **lora_precision(torch, dev),
              **lap()})
        emit({"phase": "lora_route", **time_lora_routes(torch, dev),
              **lap()})

        phase = "parity"
        emit({"phase": "parity", **parity(torch, dev), **lap()})
        phase = "train_parity"
        emit({"phase": "train_parity", **train_parity(torch, dev), **lap()})

        phase = "engines"
        en, eng = engines_phase(torch, dev)
        emit({"phase": "engines", **en, **lap()})
        phase = "quantize_split"
        emit({"phase": "quantize_split", **quantize_split(torch, dev),
              "slice_factor": slice_factors(torch, dev), **lap()})
        phase = "health"
        emit({"phase": "health", **health_phase(torch, dev, eng), **lap()})
        phase = "journal"
        emit({"phase": "journal", **journal_phase(torch, dev, eng), **lap()})
        phase = "distributed"
        di = distributed_phase(torch, dev, eng)
        emit({"phase": "distributed", **di, **lap()})
        del eng
        torch.cuda.empty_cache()
        phase = "train_sharded"
        ts = train_sharded_phase(torch, dev)
        emit({"phase": "train_sharded", **ts, **lap()})
        torch.cuda.empty_cache()
        phase = "methods"
        emit({"phase": "methods", **methods_phase(torch, dev), **lap()})

        phase = "train"
        tr, res, args = train_phase(torch, dev)
        emit({"phase": "train", **tr, **lap()})
        phase = "train_profile"
        emit({"phase": "train_profile",
              **profile_train(torch, dev, res, args), **lap()})
        del res

        phase = "serve"
        sv, res = serve_phase(torch, dev, a.layers)
        emit({"phase": "serve", **sv, **lap()})
        phase = "serve_graph"
        emit({"phase": "serve_graph", **serve_graph(torch, dev, res),
              **lap()})
        phase = "profile"
        emit({"phase": "profile", **profile_decode(torch, dev, res),
              **lap()})
        del res
        torch.cuda.empty_cache()

        phase = "moe"
        mo = moe_phase(torch, dev, a.moe_layers)
        emit({"phase": "moe", **mo, **lap()})
        phase = "configs"
        emit({"phase": "configs", **configs_phase(torch, dev), **lap()})
        phase = "ssm"
        ss = ssm_phase(torch, dev, a.hybrid_layers)
        emit({"phase": "ssm", **ss, **lap()})
        torch.cuda.empty_cache()
        phase = "encdec"
        ed = encdec_phase(torch, dev, a.vlm_layers)
        emit({"phase": "encdec", **ed, **lap()})
        torch.cuda.empty_cache()
        phase = "allocate"
        al = allocate_phase(torch, dev)
        emit({"phase": "allocate", **al, **lap()})
        torch.cuda.empty_cache()
        phase = "levers"
        lv = levers_phase(torch, dev)
        emit({"phase": "levers", **lv, **lap()})
        phase = "trace"
        tc = trace_phase(torch, dev)
        emit({"phase": "trace", **tc, **lap(),
              "script_s": time.perf_counter() - t_script})
    except Failed as e:
        emit({"phase": phase, "ok": False, "error": str(e)})
        return 1

    table = []
    moe_serve, moe_train = (mo["launches"]["serve_captured"],
                            mo["launches"]["train"])
    ssm_serve, ssm_train = ({k: sum(r["launches"][run][k]
                                    for r in ss.values())
                             for k in ("gram", "dequant_matmul_lora",
                                       "dequant_matmul", "flash_attention")}
                            for run in ("serve_captured", "train"))
    al_serve, al_train = (al["launches"]["serve_captured"],
                          al["launches"]["train"])
    lv_train = {k: sum(r["launches"][k] for r in lv["runs"].values())
                for k in ("gram", "dequant_matmul_lora", "dequant_matmul",
                          "flash_attention")}
    tc_serve, tc_train = tc["launches"]["serve"], tc["launches"]["train"]
    ed_serve, ed_train = ({k: sum(r["launches"][run][k]
                                  for r in ed.values())
                           for k in ("gram", "dequant_matmul_lora",
                                     "dequant_matmul", "flash_attention")}
                          for run in ("serve_captured", "train"))
    for name, chk, tm, launches, moe_launches, ssm_launches, al_launches, \
            ed_launches, lv_launches, tc_launches, src, tpu in (
            ("dequant_matmul", dq, dq_t, sv["launches"], moe_serve,
             ssm_serve, al_serve, ed_serve, lv_train, tc_serve,
             "src/repro_torch/kernels/csrc/dequant_matmul.cu",
             "src/repro/kernels/dequant_matmul.py:73"),
            ("flash_attention", fa, fa_t, sv["launches"], moe_serve,
             ssm_serve, al_serve, ed_serve, lv_train, tc_serve,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:94"),
            ("dequant_matmul_lora", lo, lo_t, tr["launches"], moe_train,
             ssm_train, al_train, ed_train, lv_train, tc_train,
             "src/repro_torch/kernels/csrc/dequant_matmul_lora.cu",
             "src/repro/kernels/dequant_matmul.py:134"),
            ("gram", gr, gr_t, tr["launches"], moe_train, ssm_train,
             al_train, ed_train, lv_train, tc_train,
             "src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/gram.py:41")):
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": tpu, "launches": launches[name],
                      "launches_moe": moe_launches[name],
                      "launches_ssm": ssm_launches[name],
                      "launches_allocate": al_launches[name],
                      "launches_encdec": ed_launches[name],
                      "launches_levers": lv_launches[name],
                      "launches_trace": tc_launches[name],
                      "launches_distributed": di["launches"][name],
                      "launches_train_sharded": ts["launches"][name],
                      "launches_compile_cache":
                          cc["warm"]["launches"].get(name, 0),
                      "max_abs_err": chk["max_abs_err"], "ms": tm["ms"],
                      "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                      "bound_by": tm["bound_by"],
                      "library_ms": tm["library_ms"],
                      "calls_timed": tm["calls"]})
        if name == "flash_attention":
            table[-1]["plan_route"] = fa_t["route"]
            table[-1]["cache_4096"] = {k: fa_long[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "route")}
            table[-1]["partial"] = {
                "launches_seq_kv": ts["seq_kv"]["launches"][name],
                "max_abs_err": fp["max_abs_err"],
                "lse_max_abs_err": fp["lse_max_abs_err"],
                "plan_route": fp_t["route"],
                **{k: fp_t[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "calls",
                                        "shard", "splits", "stages")}}
    emit({"kernels": table})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
