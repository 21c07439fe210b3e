#!/usr/bin/env python3
"""Where the fused kernel's wgmma route spends its time, on one GPU.

    python3 chip_lora_probe.py [--variants 0,1,2,4,8] [--layers 28] [--rank 64]

Run from the root of a checkout on a machine with an NVIDIA H100.  Writes a
copy of ``src/repro_torch/kernels/csrc/dequant_matmul_lora.cu`` a variant,
edited as ``PROBES`` says for each bit of the variant (1 leaves the folds
out, 2 the weight stages' wgmmas, 4 launches the prologue alone, 8 records
``clock64`` at every stage's events), into the git-ignored
``build/lora_probe/``, compiles the copies in parallel, then times one
Qwen3-1.7B training forward's fused calls by linear shape as
``chip_smoke.time_lora`` makes them (7 linears x ``--layers`` at 1024 rows
of x, bf16, 4-bit, group 64, rank ``--rank``), replayed in a CUDA graph
between CUDA events: one JSON line a variant, microseconds a call by
shape.  Variants with bit 8 add a line a warp: the median clocks between a
stage's events (stage start, after the x wait, after the wgmmas' issue,
after the next stage's loads, after the wgmma wait, after the folds, after
the next stage's fragments) in block 0's first tile of the last shape
timed.  Bits 1, 2 and 4 give wrong results by design: they time parts of
the kernel.  Variant 0 is the source as it stands.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "dequant_matmul_lora.cu"
EVENTS = ("x_wait", "issue", "next_loads", "wgmma_wait", "folds", "next_frags")


# clock64 at event ev of stage ks of block 0's first tile, into dq_trace
_TRACE = """  auto trace = [&](int ev, int ks) {
    const bool on = blockIdx.x == 0 && q == 0 && lane == 0 && ks < 64;
    long long* dst = &dq_trace[warp][ks & 63][ev];
    asm volatile("{\\n.reg .pred p;\\n.reg .u64 c;\\nsetp.ne.b32 p, %1, 0;\\n"
                 "mov.u64 c, %%clock64;\\n@p st.global.u64 [%0], c;\\n}\\n"
                 :: "l"(dst), "r"((int)on) : "memory");
  };
"""
_FOLD = "  auto fold = [&](float (&a)[NA], float (&p)[NA], float2 s) {\n"
_WEIGHT_WGMMAS = (
    "      wgmma_rs<CT>(part[0], frag[b] + 4 * kk, dx + 2 * kk, kk > 0);\n"
    "      wgmma_rs<CT>(part[1], frag[b] + 4 * kk, dx + CT * 8 + 2 * kk, kk > 0);\n")
_STAGE = "  // weight stage ks of the tile (x stage i, weight stage j), its fragments\n"
# each bit: (text, replacement) edits of the source, every text found once
PROBES = {
    1: [(_FOLD, _FOLD + "    return;\n")],
    2: [(_WEIGHT_WGMMAS, "")],
    4: [("    if (!rc)\n      rc = wgmma_by_bits(",
         "    if (false)\n      rc = wgmma_by_bits(")],
    8: [("\nnamespace {\n", "\n__device__ long long dq_trace[8][64][8];\n\nnamespace {\n"),
        (_STAGE, _TRACE + _STAGE),
        ("    const bool corr = ks % WG_CB == WG_CB - 1 || ks + 1 == kt;\n",
         "    const bool corr = ks % WG_CB == WG_CB - 1 || ks + 1 == kt;\n"
         "    trace(0, ks);\n"),
        ("    fence_acc(part[0]);\n    fence_acc(part[1]);\n"
         "    fence_acc(acc[0]);\n    fence_acc(acc[1]);\n    wgmma_fence();\n",
         "    trace(1, ks);\n    fence_acc(part[0]);\n    fence_acc(part[1]);\n"
         "    fence_acc(acc[0]);\n    fence_acc(acc[1]);\n    wgmma_fence();\n"),
        ("    wgmma_commit();\n    if (ks + 1 < kt) fetch(",
         "    wgmma_commit();\n    trace(2, ks);\n    if (ks + 1 < kt) fetch("),
        ("    wgmma_wait<0>();\n    fence_acc(part[0]);",
         "    trace(3, ks);\n    wgmma_wait<0>();\n    fence_acc(part[0]);"),
        ("    fold(acc[0], part[0], sv[b]);",
         "    trace(4, ks);\n    fold(acc[0], part[0], sv[b]);"),
        ("    if (ks + 1 < kt) convert(",
         "    trace(5, ks);\n    if (ks + 1 < kt) convert("),
        ("    ++j;\n  };\n", "    trace(6, ks);\n    ++j;\n  };\n"),
        (None, '\nextern "C" int dq_probe_read(void* dst) {\n'
               "  return (int)cudaMemcpyFromSymbol(dst, dq_trace, sizeof(dq_trace));\n"
               "}\n")],
}


def probe_source(text: str, variant: int) -> str:
    """The kernel's source with the edits of every bit of ``variant``
    (``None`` as the text appends the replacement)."""
    for bit, edits in PROBES.items():
        if not variant & bit:
            continue
        for old, new in edits:
            if old is None:
                text += new
                continue
            if text.count(old) != 1:
                raise ValueError(f"probe bit {bit}: expected one {old!r}")
            text = text.replace(old, new)
    return text


def build(variants, out: Path) -> dict:
    """One library a variant, compiled in parallel; {variant: path}."""
    from repro_torch.core.compile_cache import nvcc_path
    from repro_torch.kernels.build import NVCC_FLAGS
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    text = SRC.read_text()
    libs, procs = {}, {}
    for v in variants:
        src = out / f"dequant_matmul_lora.probe{v}.cu"
        src.write_text(probe_source(text, v))
        libs[v] = out / f"dequant_matmul_lora.probe{v}.so"
        procs[v] = subprocess.Popen(
            [nvcc_path(), *flags, "-o", str(libs[v]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"probe variant {v}: nvcc failed\n{log}")
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 chip_lora_probe.py")
    ap.add_argument("--variants", default="0,1,2,4,8")
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--rank", type=int, default=64)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_lora_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import dequant_matmul as dq
    variants = [int(v) for v in a.variants.split(",")]
    libs = {v: ctypes.CDLL(str(path))
            for v, path in build(variants, ROOT / "build" / "lora_probe").items()}
    fns = {}
    for v, lib in libs.items():
        fns[v] = lib.dqmm_lora_launch
        fns[v].argtypes = dq._lora_argtypes
        fns[v].restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    M, bits, g, r, bf = cs.TRAIN_TOKENS, 4, 64, a.rank, torch.bfloat16
    res: dict = {v: {} for v in variants}
    for K, N in sorted(set(cs.QWEN_LINEARS)):
        calls = a.layers * sum(1 for s in cs.QWEN_LINEARS if s == (K, N))
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        sets = []
        for _ in range(calls):
            sets.append((
                torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                              dtype=torch.uint8),
                torch.rand((K // g, N), generator=gen, device=dev) * 1e-2,
                torch.randint(0, 16, (K // g, N), generator=gen,
                              device=dev).float(),
                (torch.randn((K, r), generator=gen, device=dev)
                 / K ** 0.5).to(bf),
                (torch.randn((N, r), generator=gen, device=dev)
                 * 0.1).to(bf)))
        plan = dq.lora_plan_for(x, *sets[0], g)
        hl = torch.empty((2 * M, max(r, 8)), dtype=bf, device=dev)
        gz = torch.empty((M, -(-K // (64 * dq._WG_CB)) * 4 * dq._WG_CB),
                         dtype=bf, device=dev)
        out = torch.empty((M, N), dtype=bf, device=dev)
        for v, fn in fns.items():
            def run():
                for p, s, z, la, lb in sets:
                    rc = fn(x.data_ptr(), p.data_ptr(), s.data_ptr(),
                            z.data_ptr(), la.data_ptr(), lb.data_ptr(),
                            out.data_ptr(), hl.data_ptr(), gz.data_ptr(),
                            M, K, N, bits, g, r, 2, 1, plan.bm, plan.grid,
                            plan.xa_splits, plan.xa_chunk,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"probe variant {v}: launch {rc}")
            ms = cs.time_graph(torch, run, reps=5)
            res[v][f"{K}x{N}"] = 1e3 * ms / calls
        del sets
    for v in variants:
        print(json.dumps({"variant": v, "us_a_call": res[v],
                          "card": torch.cuda.get_device_name(0)}))
    for v, lib in libs.items():
        if not v & 8:
            continue
        buf = np.zeros((8, 64, 8), dtype=np.int64)
        if lib.dq_probe_read(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("dq_probe_read failed")
        for w in range(8):
            t = buf[w, :, :7]
            live = t[:, 0] > 0
            d = np.diff(t[live], axis=1)
            print(json.dumps({
                "variant": v, "warp": w,
                "stage_clocks": float(np.median(np.diff(t[live][:, 0]))),
                "clocks": dict(zip(EVENTS, (float(x) for x in
                                            np.median(d, axis=0))))}))
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
