#!/usr/bin/env python3
"""A kernel's time in this checkout against another tree's, in turns on
one GPU.

    python3 chip_lora_ab.py --parent DIR [--rounds N] [--timing lora|flash]

Run from the root of a checkout on a machine with one NVIDIA GPU.  DIR
holds another checkout of the repository (for a commit,
``git archive COMMIT | tar -x -C DIR``), whose ``src/repro_torch`` is
timed beside this one's.  Each tree runs in its own process (its kernels
built into its own ``build/``) and times, twice, with this checkout's
``chip_smoke.py`` (CUDA graphs replayed between CUDA events):
``--timing lora`` (the default) ``chip_smoke.time_lora``, one Qwen3-1.7B
training forward's fused calls (7 linears x 28 layers at 1024 rows, bf16,
4-bit, group 64, rank 64), and each distinct linear shape's calls alone
(``lora:KxN``); ``--timing flash`` ``flash_attention``'s bf16
decode as the ``kernels`` phase times it: the partial mode at decode_32k's
shard (``time_flash_partial``) and a 28-layer decode step at a 128- and a
4096-key cache (``time_flash``), each on the tree's own plan.  The order
is parent, change, change, parent (``--rounds`` such rounds).  One JSON
line a run, then one with each tree's times and the change's median over
the parent's, a timing each.  Exits 0 when every run finished.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def time_tree(tree: Path, timing: str) -> dict:
    """The ``timing``'s calls twice on the sources under ``tree``:
    ``{"ms": {name: [ms, ms]}, "library_ms": ..., "bound_ms": ...}``."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {"lora": {"lora": lambda: cs.time_lora(torch, dev)},
            "flash": {
                "partial": lambda: cs.time_flash_partial(torch, dev,
                                                         sweep=False),
                "cache_128": lambda: cs.time_flash(torch, dev, sweep=False),
                "cache_4096": lambda: cs.time_flash(
                    torch, dev, T=4096, lens=(4096, 3072, 1024, 1),
                    sweep=False)}}[timing]
    got = {name: [fn() for _ in range(2)] for name, fn in runs.items()}
    return {"tree": str(tree),
            "ms": {n: [r["ms"] for r in rs] for n, rs in got.items()},
            "library_ms": {n: [r["library_ms"] for r in rs]
                           for n, rs in got.items()},
            "bound_ms": {n: rs[0]["bound_ms"] for n, rs in got.items()},
            "by_shape": {n: [{k: v["ms"] for k, v in r["by_shape"].items()}
                             for r in rs]
                         for n, rs in got.items() if "by_shape" in rs[0]},
            "plans": {n: rs[0]["plans"] for n, rs in got.items()
                      if "plans" in rs[0]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 chip_lora_ab.py")
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timing", choices=("lora", "flash"), default="lora")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one run, internal
    a = ap.parse_args(argv)
    if a.tree:
        print(json.dumps(time_tree(Path(a.tree), a.timing)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_lora_ab: CUDA is not available", file=sys.stderr)
        return 1
    parent = Path(a.parent or "").resolve()
    if not a.parent or not (parent / "src" / "repro_torch").is_dir() or \
            not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_lora_ab: --parent must name another checkout, and this "
              "script must run from one", file=sys.stderr)
        return 1
    trees = {"parent": parent, "change": ROOT}
    times: dict = {}
    for _ in range(a.rounds):
        for name in ("parent", "change", "change", "parent"):
            proc = subprocess.run(
                [sys.executable, __file__, "--tree", str(trees[name]),
                 "--timing", a.timing],
                capture_output=True, text=True, cwd=ROOT, timeout=900)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.splitlines()[-1])
            for timing, ms in row["ms"].items():
                times.setdefault(timing, {"parent": [], "change": []})
                times[timing][name] += ms
            for timing, runs in row["by_shape"].items():
                for shape in runs[0]:
                    t = times.setdefault(f"{timing}:{shape}",
                                         {"parent": [], "change": []})
                    t[name] += [run[shape] for run in runs]
            print(json.dumps({"run": name, **row}), flush=True)
    print(json.dumps({"ms": times, "change_over_parent": {
        timing: statistics.median(t["change"])
        / statistics.median(t["parent"]) for timing, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
