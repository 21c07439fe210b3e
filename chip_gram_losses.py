#!/usr/bin/env python3
"""Fine-tuning losses of the full-width train run with the calibration
Grams taken three ways, and those Grams' errors, on one GPU.

    python3 chip_gram_losses.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  Runs
``chip_smoke.py``'s train phase (``repro_torch.launch.train`` on
qwen3-1.7b at full width, CLoQ 4-bit, 4 calibration batches, 4 LoRA
steps) three times, each in its own process, with every calibration
Gram (bf16 activations) taken by

* ``wgmma``: the ``gram`` kernel as its plan picks it (tensor cores);
* ``fma``: the ``gram`` kernel forced onto its CUDA-core route (f32 FMAs
  in token order, the only route before the tensor-core one);
* ``f64``: ``x.T @ x`` in float64, rounded to f32 once (the plain
  version, f32 ``torch.matmul``, gives the ``fma`` route's bits).

First a line of each route's Gram error against the f64 one on random
bf16 x at T = 1024 and each calibration width (largest and mean absolute
error over the largest entry).  Then one JSON line a route (losses, gram
launches, quantize seconds), then the largest relative difference of
each route's losses from the ``fma`` route's.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUTES = ("wgmma", "fma", "f64")
# chip_smoke.py's train phase
ARGV = ["--arch", "qwen3-1.7b", "--method", "cloq", "--bits", "4",
        "--group-size", "64", "--rank", "64", "--calib-batches", "4",
        "--batch", "8", "--seq-len", "128", "--steps", "4", "--seed", "0"]


def _take(route: str, gm, build) -> None:
    """Make ``gm.gram_cuda`` take every Gram by ``route``."""
    if route == "fma":
        gm.plan_for = lambda x: gm.gram_plan(
            *x.shape, bf16=False, aligned=True, n_sm=build.sm_count(x.device))
    elif route == "f64":
        gm.gram_cuda = lambda x, plan=None: (
            x.double().T @ x.double()).float()


def gram_errors() -> dict:
    """Each route's Gram against the f64 one on random bf16 x (T = 1024):
    the largest and the mean absolute error over the largest entry."""
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    import torch

    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    for D in (2048, 6144):
        x = torch.randn((1024, D), generator=gen,
                        device=dev).to(torch.bfloat16)
        h64 = x.double().T @ x.double()
        for route in ("wgmma", "fma"):
            from repro_torch.kernels import gram as gm
            gm = importlib.reload(gm)
            _take(route, gm, build)
            err = (gm.gram_cuda(x).double() - h64).abs()
            scale = float(h64.abs().max())
            out[f"{route}_D{D}"] = {"max": float(err.max()) / scale,
                                    "mean": float(err.mean()) / scale}
    return out


def run_route(route: str) -> dict:
    """The train run with every calibration Gram taken by ``route``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import gram as gm
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _take(route, gm, build)
    args = train.build_parser().parse_args(ARGV + ["--device", str(dev)])
    ops.reset_launch_counts()
    res = train.run(args, get_config("qwen3-1.7b"))
    return {"route": route, "losses": res["losses"],
            "gram_launches": ops.launch_counts()["gram"],
            "quantize_s": res["quantize_s"]}


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--errors":
        print(json.dumps({"gram_rel_err_vs_f64": gram_errors()}), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--route":
        print(json.dumps(run_route(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_gram_losses: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_gram_losses: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    proc = subprocess.run([sys.executable, __file__, "--errors"],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    print(proc.stdout.strip().splitlines()[-1], flush=True)
    rows = {}
    for route in ROUTES:
        proc = subprocess.run([sys.executable, __file__, "--route", route],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=1200)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rows[route] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rows[route]), flush=True)
    base = rows["fma"]["losses"]
    spread = {route: max(abs(a - b) / abs(b)
                         for a, b in zip(rows[route]["losses"], base))
              for route in ROUTES}
    print(json.dumps({"max_rel_diff_from_fma": spread}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
