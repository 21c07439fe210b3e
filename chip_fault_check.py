#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s bf16 decode attention cases.

    python3 chip_fault_check.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  It
copies ``src/repro_torch`` into the git-ignored ``build/fault_copy/``,
plants one fault in the copy's ``flash_attention.cu`` (the cluster's
combine leaves out the last rank's partial softmax), and runs the bf16
decode cases of ``check_flash`` (``chip_smoke.FLASH_DECODE``, keys split
over a cluster) on the real sources and on the copy, each in its own
process, at q scale 1 and at ``chip_smoke.FLASH_Q_PEAK``.  One JSON line a
case: tree, q scale, cache, lengths, the plan's splits, whether the
5e-2 check passes, the error and the reference's largest output.

Exits 0 when every case passes on the real sources and the check fails
on the copy at ``FLASH_Q_PEAK`` in both 4096-key cases, i.e. when
``check_flash``'s limit can see a lost split; the last line says which.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "fault_copy"
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
# the combine's count of partials; the fault drops the last rank's
SOUND = "const int nparts = splits * kw;"
FAULT = "const int nparts = (splits > 1 ? splits - 1 : 1) * kw;"


def plant_fault(text: str) -> str:
    """The kernel source with the fault in place of the sound line."""
    if text.count(SOUND) != 1:
        raise ValueError(f"{KERNEL}: expected one line {SOUND!r}")
    return text.replace(SOUND, FAULT)


def run_cases(tree: Path) -> list[dict]:
    """The bf16 decode cases on the sources under ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    dev = torch.device("cuda", 0)
    B, Hq, Hkv, d = 4, 16, 8, 128
    out = []
    for scale in (1.0, cs.FLASH_Q_PEAK):
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        for Sk, lens in cs.FLASH_DECODE:
            q = (torch.randn((B, Hq, 1, d), generator=gen, device=dev)
                 * scale).to(torch.bfloat16)
            k, v = (torch.randn((B, Sk, Hkv, d), generator=gen, device=dev)
                    .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            o = flash_attention_cuda(q, k, v, causal=False, lengths=lengths)
            o_ref = ref.flash_attention_ref(q, k, v, causal=False,
                                            lengths=lengths)
            ok, err = cs.within(o, o_ref, cs.TOL_ATTN["bfloat16"])
            out.append({"q_scale": scale, "Sk": Sk, "lengths": list(lens),
                        "splits": plan_for(q, k, v).splits, "passes": ok,
                        "max_abs_err": err,
                        "max_abs_ref": float(o_ref.float().abs().max())})
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        for row in run_cases(Path(sys.argv[2])):
            print(json.dumps(row), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / KERNEL).is_file():
        print(f"chip_fault_check: no {KERNEL} beside {__file__}",
              file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (COPY / KERNEL).write_text(plant_fault((ROOT / KERNEL).read_text()))
    rows = {}
    for name, tree in (("sources", ROOT), ("fault", COPY)):
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rows[name] = [json.loads(ln) for ln in proc.stdout.splitlines()]
        for row in rows[name]:
            print(json.dumps({"tree": name, **row}), flush=True)
    import chip_smoke as cs
    sound = all(r["passes"] for r in rows["sources"])
    seen = all(not r["passes"] for r in rows["fault"]
               if r["q_scale"] == cs.FLASH_Q_PEAK and r["Sk"] == 4096)
    print(json.dumps({"sources_pass": sound, "fault_caught_at_4096": seen}))
    return 0 if sound and seen else 1


if __name__ == "__main__":
    sys.exit(main())
