#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--layers L]

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — both CUDA kernels compiled from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` (into the git-ignored ``build/``), with seconds.
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and at a sweep of others, with
   ``torch.cuda.synchronize()`` after each launch; then the kernel, the
   plain version and one PyTorch library call timed over one decode
   step's worth of calls (CUDA graphs replayed between CUDA events), and
   the least time the card could take for the same work.
4. parity  — the smoke model quantized on the card and decoded with the
   kernels and with the plain path: logits agree and tokens are equal.
5. serve   — ``repro_torch.launch.serve`` on qwen3-1.7b at full width with
   the CLI's full-size settings (CLoQ 4-bit, group 64, rank 64, 2 x 64
   calibration tokens, batch 4, 8 requests x 16 tokens, cache 128),
   ``--layers`` deep (all 28 by default).  Both kernels' launch counters
   are reset just before and read just after; each must be > 0.
6. profile — a few more decode steps of the served model under
   ``torch.profiler``: step time, device busy and idle share, top kernels.

Then the kernel table as one JSON line, the ``nvidia-smi`` name and power
limit line, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero without the ``ok`` line, as does a host without CUDA or a
directory without the repository's ``src/repro_torch``.

TF32 is switched off for matmuls and cuDNN, so f32 references are f32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM, f32 outside the tensor cores
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}        # dequant
TOL_ATTN = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}   # flash

# the serving path's quantized linears per layer: (K, N) of q, k, v, o,
# gate, up, down at qwen3-1.7b's widths
QWEN_LINEARS = ((2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
                (2048, 6144), (2048, 6144), (6144, 2048))


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


def _quantized(torch, K, N, bits, g, dev, gen):
    from repro_torch.core.quantizer import pack_codes, quantize_int
    W = torch.randn((K, N), generator=gen, device=dev) * 0.02
    codes, s, z = quantize_int(W, bits, g)
    return pack_codes(codes, bits), s, z


def check_dequant(torch, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    main_err, cases = 0.0, 0
    main = [(4, K, N, 4, 64, torch.bfloat16) for K, N in
            sorted(set(QWEN_LINEARS))]
    sweep = [(M, K, N, bits, g, dt)
             for bits in (2, 4, 8) for M in (1, 3, 8, 128)
             for dt in (torch.float32, torch.bfloat16)
             for K, N, g in ((256, 200, 32), (384, 128, 64))]
    for i, (M, K, N, bits, g, dt) in enumerate(main + sweep):
        packed, s, z = _quantized(torch, K, N, bits, g, dev, gen)
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        y = dequant_matmul_cuda(x, packed, s, z, bits=bits, group_size=g)
        torch.cuda.synchronize()
        y_ref = ref.dequant_matmul_ref(x, packed, s, z, bits=bits,
                                       group_size=g)
        torch.cuda.synchronize()
        ok, err = within(y, y_ref, TOL[str(dt).split(".")[-1]])
        if not ok:
            raise Failed(f"dequant_matmul M={M} K={K} N={N} bits={bits} "
                         f"g={g} {dt}: max err {err}")
        if i < len(main):
            main_err = max(main_err, err)
        cases += 1
    return {"cases": cases, "max_abs_err": main_err}


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "calls": len(sets), "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def check_flash(torch, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
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
    main_err = 0.0
    for i, (B, Hq, Hkv, Sq, Sk, d, causal, lens, dt, cached) in \
            enumerate(cases):
        q = torch.randn((B, Hq, Sq, d), generator=gen, device=dev).to(dt)
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
        o = flash_attention_cuda(q, k, v, causal=causal, lengths=lengths)
        torch.cuda.synchronize()
        o_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                        lengths=lengths)
        torch.cuda.synchronize()
        ok, err = within(o, o_ref, TOL_ATTN[str(dt).split(".")[-1]])
        if not ok:
            raise Failed(f"flash_attention case {i} {(B, Hq, Hkv, Sq, Sk, d)}"
                         f" causal={causal} {dt}: max err {err}")
        if i == 0:
            main_err = err
    return {"cases": len(cases), "max_abs_err": main_err}


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


def time_flash(torch, dev, layers: int = 28) -> dict:
    """One decode step's attention calls: ``layers`` calls at B = 4, Hq = 16,
    Hkv = 8, Sq = 1, cache 128, d = 128, bf16, mixed lengths, each on its
    own KV cache read through the decode path's transpose."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    B, Hq, Hkv, T, d = 4, 16, 8, 128, 128
    lens = (128, 97, 40, 1)
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "calls": len(sets), "bytes": nbytes, "flops": flops}


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


def serve_phase(torch, dev, layers: int) -> tuple[dict, dict]:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.utils import assert_finite, tree_paths, tree_size_bytes
    argv = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
            "--batch", "4", "--requests", "8", "--max-new", "16",
            "--cache-len", "128", "--seed", "0", "--device", str(dev)]
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
    out = {"layers": layers, "argv": argv, "quantize_s": res["quantize_s"],
           "decode_s": s["seconds"], "decode_steps": s["steps"],
           "decode_tok_s": s["tok_s"], "requests_done": s["requests_done"],
           "quantized_linears": n_quant,
           "param_gb": tree_size_bytes(res["params"]) / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": counts, "logits_finite": s["all_finite"],
           "nonfinite": bad}
    if min(counts.values()) <= 0:
        raise Failed(f"a kernel was not launched on the serve path: {counts}")
    if bad or not s["all_finite"] or s["requests_done"] != 8 or \
            n_quant != 7:
        raise Failed(f"serve output wrong: {out}")
    return out, res


def profile_decode(torch, dev, res) -> dict:
    """Where a decode step's time goes: the served model decodes 4 requests
    x 8 tokens under ``torch.profiler``.  Device busy time is the sum of
    the device-side events' (kernels', copies') times — one stream, so
    they do not overlap; operator-level events, which also carry the time
    of the kernels they launch, are left out so nothing counts twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    kw = dict(batch=4, cache_len=128, requests=4, max_new=8, seed=1,
              device=dev)
    serve.serve_fixed_slots(res["params"], res["cfg"], **kw)     # warm
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        s = serve.serve_fixed_slots(res["params"], res["cfg"], **kw)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"steps": s["steps"], "wall_s": s["seconds"],
            "step_ms": 1e3 * s["seconds"] / s["steps"],
            "device_busy_s": busy,
            "device_idle_share": (1 - busy / s["seconds"]) if busy else None,
            "top_kernels_ms_per_step": [
                [e.key[:60], dev_us(e) / 1e3 / s["steps"], e.count]
                for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served qwen3-1.7b (widths are never "
                         "cut)")
    a = ap.parse_args(argv)
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
              "allow_tf32": {"matmul": False, "cudnn": False}})

        phase = "build"
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        logs = build.build_all()
        ptxas = [ln.strip() for log in logs.values()
                 for ln in log.splitlines() if "registers" in ln]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "dir": str(build.build_dir().relative_to(ROOT)),
              "sources": list(build.SOURCES), "ptxas": ptxas[:12]})

        phase = "kernels"
        dq = check_dequant(torch, dev)
        fa = check_flash(torch, dev)
        dq_t = time_dequant(torch, dev)
        fa_t = time_flash(torch, dev)
        emit({"phase": "kernels", "dequant_matmul": {**dq, **dq_t},
              "flash_attention": {**fa, **fa_t},
              "work": "one 28-layer qwen3-1.7b decode step at batch 4"})

        phase = "parity"
        emit({"phase": "parity", **parity(torch, dev)})

        phase = "serve"
        sv, res = serve_phase(torch, dev, a.layers)
        emit({"phase": "serve", **sv})
        phase = "profile"
        emit({"phase": "profile", **profile_decode(torch, dev, res)})
        del res
    except Failed as e:
        emit({"phase": phase, "ok": False, "error": str(e)})
        return 1

    launches = sv["launches"]
    table = []
    for name, chk, tm, src, tpu in (
            ("dequant_matmul", dq, dq_t,
             "src/repro_torch/kernels/csrc/dequant_matmul.cu",
             "src/repro/kernels/dequant_matmul.py:73"),
            ("flash_attention", fa, fa_t,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:94")):
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": tpu, "launches": launches[name],
                      "max_abs_err": chk["max_abs_err"], "ms": tm["ms"],
                      "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                      "bound_by": tm["bound_by"],
                      "library_ms": tm["library_ms"],
                      "calls_timed": tm["calls"]})
    emit({"kernels": table})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
