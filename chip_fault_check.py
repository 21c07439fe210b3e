#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s bf16 decode attention cases,
its gram cases, its kernel-vs-plain decode logits check, its fused LoRA
kernel's precision check, its distributed and sharded-step checks, its
sequence-sharded decode, and its analysis and compile_cache phases.

    python3 chip_fault_check.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  It
copies ``src/repro_torch`` into the git-ignored ``build/fault_copy/`` and
plants two faults in the copy:

* ``flash_attention.cu``: the cluster's combine leaves out the last rank's
  partial softmax.  The bf16 decode cases of ``check_flash``
  (``chip_smoke.FLASH_DECODE``, keys split over a cluster) run at q scale
  1 and at ``chip_smoke.FLASH_Q_PEAK``, and the partial mode at
  decode_32k's shard (``chip_smoke.FLASH_PARTIAL``'s bf16 2048-key case,
  q at ``FLASH_Q_PEAK``) is held on ``out`` and ``lse``.
* ``gram.cu``: the tensor-core route loads the last token stage of every
  tile from the stage before it, so the last 64 tokens are lost and the
  64 before them count twice.  The bf16 cases of ``check_gram`` that take
  the tensor-core route (the calibration shapes and
  ``chip_smoke.GRAM_WGMMA``) run at the bf16 and the f32 tolerance.

A second copy, ``build/fault_copy_dequant/``, holds a third fault alone:

* ``dequant_matmul.cu``: the decode route ("mma") takes the zeros of half
  the columns one off in the first K stage (its first group or groups).
  The logits cases quantize Qwen3-1.7B at full width, 1 layer (RTN, 4 and
  2 bits, group 64, rank 64: no calibration) and hold kernel against plain
  decode logits to ``chip_smoke.logits_limit``, as the configs, ssm and
  allocate phases do.

A third copy, ``build/fault_copy_lora/``, holds a fourth:

* ``dequant_matmul_lora.cu``: the wgmma route folds each stage's sums
  with its group's scale rounded to bf16 (the kind of rounding the kernel
  exists to avoid).  The cases are ``chip_smoke.lora_precision``'s (K = 14336,
  weights of std 0.02 and K^-0.5), held to the exact product within
  ``LORA_EXACT_RTOL * |exact| + LORA_EXACT_ATOL`` and to the plain
  version within the JAX bf16 tolerance.

A fourth copy, ``build/fault_copy_dist/``, holds a fifth, in Python:

* ``core/loftq.py``: ``svd_lowrank_topr`` skips its all-reduce, so each
  rank of the distributed engine factorizes its local Gram only.  The
  cases are ``chip_smoke.py``'s distributed checks: CLoQ and LoftQ
  quantized column-sharded by 2 ranks on the card over gloo, each site
  held against the unsharded batched engine (``chip_smoke.dist_compare``:
  ``A @ B^T``, the calibrated objective, codes, scales, zeros).

A fifth copy, ``build/fault_copy_sharded/``, holds a sixth, in Python:

* ``models/modules.py``: a sharded linear's whole LoRA factor (``lora_a``
  of a column linear, ``lora_b`` of a row one) no longer has its gradient
  summed over the model axis, so each rank keeps its part.  The cases are
  ``chip_smoke.py``'s ``train_sharded`` checks (4 gloo ranks on the card,
  a (data 2, model 2) mesh, Qwen3-1.7B at full width against the
  unsharded step, whose gradients must fail).

A sixth copy, ``build/fault_copy_gated/``, holds a seventh, in Python:

* ``models/modules.py``: a split ``rmsnorm_apply`` (the Mamba block's
  gated norm) normalizes over the rank's channels only, its all-reduce of
  the sum of squares dropped.  The cases are ``train_sharded``'s
  ``SHARDED_FAMILIES`` alone; the Mamba2-370M and Zamba2-7B cases must
  fail on a numerical check (their gradients or their decode), not only
  on the collective count that the dropped all-reduce changes.

A seventh copy, ``build/fault_copy_seqkv/``, holds an eighth, in Python:

* ``models/parallel.py``: ``combine_softmax`` (the sequence-sharded
  decode's combine of the ranks' partial softmaxes) weighs each rank's
  partial without the rescale by the global max: 1 for a rank with a
  valid key, 0 for one without, in place of ``exp(lse - M)``.  The case
  is ``train_sharded``'s ``seq_kv`` alone (Qwen3-30B-A3B, 8 gloo ranks, a
  (data 1, model 8) mesh, its cache sharded along the sequence), which
  must fail on its decode logits.

The ninth plant takes two copies, one phase each:

* ``build/fault_copy_cache/``, ``core/compile_cache.py``: no error marks a
  stored kernel library corrupt (``CORRUPT = ()``), so the cache opens the
  library as it finds it and never rebuilds it.  The case is
  ``chip_smoke.py``'s ``compile_cache`` phase, whose second serve process
  (the ``dequant_matmul`` library cut to half its bytes) must fail.
* ``build/fault_copy_purity/``, ``analysis/rules_trace.py``: PURITY
  ignores ``.item()``.  The case is the ``analysis`` phase, which must fail
  on PURITY: the ``.item()`` step's capture raises on the card where the
  rule no longer flags it.

The attention and gram cases run on the real sources and on the first
copy, the logits cases on the real sources and on the second, the
precision cases on the real sources and on the third, the distributed
cases on the real sources and on the fourth, the sharded-step cases on
the real sources and on the fifth, the families' sharded cases on the
sixth, the seq_kv case on the seventh, each tree in its own process.  One JSON line a case: tree,
kernel, shape, the plan's split or route, whether the checks pass, the
error and the reference's largest value (for the logits, the limit).

Exits 0 when every case passes on the real sources, the attention check
fails on the copy at ``FLASH_Q_PEAK`` in both 4096-key cases and at
decode_32k's partial shard, the gram
check fails on the copy in every case with more than one token stage,
the logits check fails on the second copy in every case, the precision
check on the third in every case, and the distributed check on the
fourth for both methods on ``A @ B^T``, the sharded step's check on
the fifth on the LoRA gradients, the Mamba families' sharded cases on
the sixth, the seq_kv case on the seventh on its logits, and the
compile_cache and analysis phases on the ninth plant's two copies (the
analysis phase on PURITY); the last line says which.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "fault_copy"
DQ_COPY = ROOT / "build" / "fault_copy_dequant"
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
# the combine's count of partials; the fault drops the last rank's
SOUND = "const int nparts = splits * kw;"
FAULT = "const int nparts = (splits > 1 ? splits - 1 : 1) * kw;"
GRAM_KERNEL = Path("src/repro_torch/kernels/csrc/gram.cu")
# the first token of a stage's loads; the fault loads the last stage's
# from the stage before it
GRAM_SOUND = "const int t0 = ks * WG_BK;"
GRAM_FAULT = "const int t0 = (ks + 1 == kt && ks > 0 ? ks - 1 : ks) * WG_BK;"
DQ_KERNEL = Path("src/repro_torch/kernels/csrc/dequant_matmul.cu")
# the decode route's zeros of a stage (columns c, c+1 of each 4); the fault
# takes them one off in the first K stage
DQ_SOUND = "nz[c] = -(OFF + z.x); nz[c + 1] = -(OFF + z.y);"
DQ_FAULT = ("nz[c] = -(OFF + z.x + (s_lo + i == 0)); "
            "nz[c + 1] = -(OFF + z.y + (s_lo + i == 0));")
LORA_COPY = ROOT / "build" / "fault_copy_lora"
DIST_COPY = ROOT / "build" / "fault_copy_dist"
DIST_SOURCE = Path("src/repro_torch/core/loftq.py")
# the Gram trick's one collective; the fault leaves it out
DIST_SOUND = "    G = all_reduce_sum(G.contiguous(), group)"
DIST_FAULT = "    G = G.contiguous()"
SHARDED_COPY = ROOT / "build" / "fault_copy_sharded"
SHARDED_SOURCE = Path("src/repro_torch/models/modules.py")
# the model-axis sum of a sharded linear's whole LoRA factor's gradient;
# the fault leaves it out
SHARDED_SOUND = "        local[other] = parallel.copy_to(local[other], group)"
SHARDED_FAULT = "        local[other] = local[other]"
GATED_COPY = ROOT / "build" / "fault_copy_gated"
GATED_SOURCE = Path("src/repro_torch/models/modules.py")
# the Mamba gated norm's sum of squares over every rank's channels; the
# fault normalizes over the rank's channels only, the all-reduce dropped
GATED_SOUND = ("        ss = parallel.reduce_from("
               "parallel.copy_to(ss, group), group)")
GATED_FAULT = "        ss = ss * parallel.group_size(group)"
# the families with Mamba blocks, whose train_sharded cases must fail on it
GATED_FAMILIES = ("mamba2-370m", "zamba2-7b")
# the family whose gradients the sixth plant must move
SHARDED_FAMILY = "qwen3-1.7b"
SEQKV_COPY = ROOT / "build" / "fault_copy_seqkv"
SEQKV_SOURCE = Path("src/repro_torch/models/parallel.py")
# each rank's weight in the combine of the partial softmaxes; the fault
# drops the rescale by the ranks' max of the log-sum-exp
SEQKV_SOUND = "    w = torch.exp(lse - m)"
SEQKV_FAULT = "    w = torch.isfinite(lse).float()"
CACHE_COPY = ROOT / "build" / "fault_copy_cache"
CACHE_SOURCE = Path("src/repro_torch/core/compile_cache.py")
# what marks a stored library corrupt; the fault: nothing does
CACHE_SOUND = "CORRUPT = (OSError, ValueError, KeyError, AttributeError)"
CACHE_FAULT = "CORRUPT = ()"
PURITY_COPY = ROOT / "build" / "fault_copy_purity"
PURITY_SOURCE = Path("src/repro_torch/analysis/rules_trace.py")
# PURITY's host-sync finding; the fault lets .item() through
PURITY_SOUND = "        elif astlib.is_sync_call(node):"
PURITY_FAULT = ("        elif astlib.is_sync_call(node) and "
                "getattr(node.func, \"attr\", \"\") != \"item\":")
LORA_KERNEL = Path("src/repro_torch/kernels/csrc/dequant_matmul_lora.cu")
# the wgmma route's fold takes each stage's scales (its group's) for a
# thread's two columns from this line; the fault rounds them to bf16 first
LORA_SOUND = "sv[b] = *reinterpret_cast<const float2*>(slot + L::SC + 4 * na);"
LORA_FAULT = ("sv[b] = __bfloat1622float2(__float22bfloat162_rn("
              "*reinterpret_cast<const float2*>(slot + L::SC + 4 * na)));")


def _plant(text: str, sound: str, fault: str, where: Path) -> str:
    if text.count(sound) != 1:
        raise ValueError(f"{where}: expected one line {sound!r}")
    return text.replace(sound, fault)


def plant_fault(text: str) -> str:
    """The attention kernel's source with its fault in place of the sound
    line."""
    return _plant(text, SOUND, FAULT, KERNEL)


def plant_gram_fault(text: str) -> str:
    """The gram kernel's source with its fault in place of the sound
    line."""
    return _plant(text, GRAM_SOUND, GRAM_FAULT, GRAM_KERNEL)


def plant_dequant_fault(text: str) -> str:
    """The decode kernel's source with its fault in place of the sound
    line."""
    return _plant(text, DQ_SOUND, DQ_FAULT, DQ_KERNEL)


def plant_lora_fault(text: str) -> str:
    """The fused kernel's source with its fault in place of the sound
    line."""
    return _plant(text, LORA_SOUND, LORA_FAULT, LORA_KERNEL)


def plant_dist_fault(text: str) -> str:
    """``loftq.py`` with the Gram trick's all-reduce left out."""
    return _plant(text, DIST_SOUND, DIST_FAULT, DIST_SOURCE)


def plant_sharded_fault(text: str) -> str:
    """``models/modules.py`` with the LoRA factor's model-axis gradient
    sum left out."""
    return _plant(text, SHARDED_SOUND, SHARDED_FAULT, SHARDED_SOURCE)


def plant_gated_fault(text: str) -> str:
    """``models/modules.py`` with a split RMSNorm (Mamba's gated norm)
    taken over the rank's channels only."""
    return _plant(text, GATED_SOUND, GATED_FAULT, GATED_SOURCE)


def plant_seqkv_fault(text: str) -> str:
    """``models/parallel.py`` with the partial softmaxes combined without
    the rescale by the global max."""
    return _plant(text, SEQKV_SOUND, SEQKV_FAULT, SEQKV_SOURCE)


def plant_cache_fault(text: str) -> str:
    """``core/compile_cache.py`` with no error marking a library
    corrupt."""
    return _plant(text, CACHE_SOUND, CACHE_FAULT, CACHE_SOURCE)


def plant_purity_fault(text: str) -> str:
    """``analysis/rules_trace.py`` with PURITY blind to ``.item()``."""
    return _plant(text, PURITY_SOUND, PURITY_FAULT, PURITY_SOURCE)


def phase_cases(torch, cs, dev, phase: str) -> list[dict]:
    """``chip_smoke.py``'s ``analysis`` or ``compile_cache`` phase on the
    sources imported, its failure returned rather than raised."""
    run = {"analysis": cs.analysis_phase,
           "compile_cache": cs.compile_cache_phase}[phase]
    try:
        run(torch, dev)
    except cs.Failed as e:
        return [{"kernel": phase, "passes": False, "error": str(e)[:2000]}]
    return [{"kernel": phase, "passes": True, "error": ""}]


def purity_caught(rows: list) -> bool:
    """Whether the purity copy's rows show the plant caught: the analysis
    phase fails, on PURITY."""
    return bool(rows) and all(not r["passes"] and "PURITY" in r["error"]
                              for r in rows)


def cache_caught(rows: list) -> bool:
    """Whether the cache copy's rows show the plant caught: the
    compile_cache phase fails."""
    return bool(rows) and all(not r["passes"] and
                              r["error"].startswith("compile_cache")
                              for r in rows)


def seqkv_caught(rows: list) -> bool:
    """Whether the eighth copy's rows show the plant caught: the seq_kv
    case fails on its decode logits."""
    return bool(rows) and all("seq_kv:decode" in r["failed_checks"]
                              for r in rows)


def gated_caught(rows: list) -> bool:
    """Whether the seventh copy's rows show the plant caught: each of
    ``GATED_FAMILIES`` fails a numerical check (its gathered gradients or
    its decode logits), whatever its collective counts say."""
    return bool(rows) and all(
        f"{arch}:grad" in r["failed_checks"] or
        f"{arch}:decode" in r["failed_checks"]
        for r in rows for arch in GATED_FAMILIES)


def flash_cases(torch, cs, dev) -> list[dict]:
    """The bf16 decode attention cases on the sources imported."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
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
            out.append({"kernel": "flash_attention", "q_scale": scale,
                        "Sk": Sk, "lengths": list(lens),
                        "splits": plan_for(q, k, v).splits, "passes": ok,
                        "max_abs_err": err,
                        "max_abs_ref": float(o_ref.float().abs().max())})
    return out


def flash_partial_case(torch, cs, dev) -> dict:
    """The partial mode at decode_32k's shard on the sources imported:
    ``out`` within the JAX bf16 tolerance and ``lse`` within
    ``chip_smoke.FLASH_LSE_TOL`` over the rows with a valid key."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     plan_for)
    B, Hq, Hkv, T, d, dname, lens = next(
        c for c in cs.FLASH_PARTIAL if c[3] == 2048 and c[5] == "bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q = (torch.randn((B, Hq, 1, d), generator=gen, device=dev)
         * cs.FLASH_Q_PEAK).to(torch.bfloat16)
    k, v = (torch.randn((B, T, Hkv, d), generator=gen, device=dev)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = flash_attention_cuda(q, k, v, causal=False, lengths=lengths,
                                  return_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=False,
                                             lengths=lengths, return_lse=True)
    live = lengths > 0
    ok, err = cs.within(o[live], o_ref[live], cs.TOL_ATTN[dname])
    lse_err = float((lse[live] - lse_ref[live]).abs().max())
    return {"kernel": "flash_partial", "q_scale": cs.FLASH_Q_PEAK, "Sk": T,
            "lengths": list(lens), "splits": plan_for(q, k, v).splits,
            "passes": ok and lse_err <= cs.FLASH_LSE_TOL[dname],
            "max_abs_err": err, "lse_err": lse_err,
            "max_abs_ref": float(o_ref.abs().max())}


def partial_caught(rows: list) -> bool:
    """Whether the first copy's rows show the plant caught at decode_32k's
    partial shard: its case fails (on ``out`` or ``lse``)."""
    got = [r for r in rows if r["kernel"] == "flash_partial"]
    return bool(got) and all(not r["passes"] for r in got)


def gram_cases(torch, cs, dev) -> list[dict]:
    """The bf16 gram cases of the tensor-core route on the sources
    imported."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram_cuda, plan_for
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    shapes = [(cs.TRAIN_TOKENS, D) for D in (2048, 6144)] + list(cs.GRAM_WGMMA)
    out = []
    for T, D in shapes:
        x = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
        h = gram_cuda(x)
        h_ref = ref.gram_ref(x)
        ok, err = cs.within(h, h_ref, cs.TOL_GRAM["bfloat16"])
        ok32 = cs.within(h, h_ref, cs.TOL_GRAM["float32"])[0]
        out.append({"kernel": "gram", "T": T, "D": D,
                    "route": plan_for(x).route,
                    "passes": ok and bool(torch.equal(h, h.T)),
                    "passes_f32_tol": ok32, "max_abs_err": err,
                    "max_abs_ref": float(h_ref.abs().max())})
    return out


def logits_cases(torch, cs, dev) -> list[dict]:
    """Kernel against plain decode logits of Qwen3-1.7B at full width, 1
    layer, RTN-quantized at 4 and 2 bits on the sources imported."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels.dequant_matmul import plan_for
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    cfg = get_config("qwen3-1.7b", n_layers=1)
    params = init_params(cfg, seed=0, device=dev)
    out = []
    for bits in (4, 2):
        recipe = QuantRecipe.single("rtn", QSpec(bits=bits, group_size=64,
                                                 rank=64))
        qp, qcfg, _ = quantize_model(params, cfg, [], recipe=recipe)
        q = qp["blocks"]["attn"]["q"]
        x = torch.zeros((4, q["lora_a"].shape[-2]), dtype=torch.bfloat16,
                        device=dev)
        lg = cs._kernel_vs_plain_logits(torch, dev, qp, qcfg)
        out.append({"kernel": "logits", "bits": bits,
                    "route": plan_for(x, q["qcodes"][0], q["scales"][0],
                                      q["zeros"][0], 64).route,
                    "passes": lg["within"], **lg})
        del qp
    return out


def lora_cases(torch, cs, dev) -> list[dict]:
    """``chip_smoke.lora_precision``'s cases on the sources imported."""
    return [{"kernel": "dequant_matmul_lora", "passes": r["holds"], **r}
            for r in cs.lora_precision_rows(torch, dev)]


def dist_cases(torch, cs, dev, tree: Path) -> list[dict]:
    """``chip_smoke.py``'s distributed checks on the sources imported: the
    unsharded references (``dist_reference``), the 2 ranks' sharded CLoQ
    and LoftQ (``dist_ranks``, no extras), each method's sites against
    them (``dist_compare``)."""
    ref = cs.dist_reference(torch, dev)
    _, leaves = cs.dist_ranks(torch, tree / "build" / "fault_dist_work",
                              extras=False)
    out = []
    for m in cs.DIST_METHODS:
        c = cs.dist_compare(torch, dev, ref, m, leaves[m])
        out.append({"kernel": "distributed", "method": m,
                    "passes": not c["failed"], "worst": c["worst"],
                    "failed_fields": sorted({f[1] for f in c["failed"]}),
                    "failed_sites": len({f[0] for f in c["failed"]})})
    return out


def _check_name(f: list) -> str:
    """A ``train_sharded`` failure's name: its case (a family, "moe" or
    "seq_kv") and check, a run's between them ("mamba2-370m:tp:loss",
    "mamba2-370m:grad", "seq_kv:decode")."""
    return ":".join(str(x) for x in f[:3 if f[1] in ("tp", "seq") else 2])


def sharded_cases(torch, cs, dev, tree: Path,
                  which: str = "all") -> list[dict]:
    """``chip_smoke.py``'s ``train_sharded`` checks on the sources
    imported, returned rather than raised: all of them, its
    ``SHARDED_FAMILIES`` alone ("families") or its seq_kv case alone
    ("seq_kv")."""
    out = cs.train_sharded_phase(
        torch, dev, tree / "build" / "fault_sharded_work", hold=False,
        families=() if which == "seq_kv" else cs.SHARDED_FAMILIES,
        moe=which == "all", seq_kv=which != "families")
    row = {"kernel": "train_sharded", "passes": not out["failed"],
           "failed_checks": sorted({_check_name(f) for f in out["failed"]}),
           "families": {a: {"loss_rel": f["tp"]["loss_rel"],
                            "grads_worst": f["grads_worst"]}
                        for a, f in out["families"].items()}}
    if "seq_kv" in out:
        row["seq_kv"] = {k: out["seq_kv"][k]
                         for k in ("max_abs_err", "limit", "max_abs_logit")}
    return [row]


def run_cases(tree: Path, which: str) -> list[dict]:
    """The attention and gram cases (``which`` "kernels"), the logits
    cases ("logits") or the precision cases ("lora") on the sources under
    ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if which == "logits":
        return logits_cases(torch, cs, dev)
    if which == "lora":
        return lora_cases(torch, cs, dev)
    if which == "dist":
        return dist_cases(torch, cs, dev, tree)
    if which == "sharded":
        return sharded_cases(torch, cs, dev, tree)
    if which == "sharded_families":
        return sharded_cases(torch, cs, dev, tree, "families")
    if which == "gated":
        return sharded_cases(torch, cs, dev, tree, "families")
    if which == "seqkv":
        return sharded_cases(torch, cs, dev, tree, "seq_kv")
    if which in ("analysis", "compile_cache"):
        return phase_cases(torch, cs, dev, which)
    return (flash_cases(torch, cs, dev) + [flash_partial_case(torch, cs, dev)]
            + gram_cases(torch, cs, dev))


def _copy(dst: Path) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        for row in run_cases(Path(sys.argv[2]), sys.argv[3]):
            print(json.dumps(row), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: CUDA is not available", file=sys.stderr)
        return 1
    if not all((ROOT / k).is_file() for k in (KERNEL, GRAM_KERNEL,
                                               DQ_KERNEL, LORA_KERNEL,
                                               DIST_SOURCE,
                                               SHARDED_SOURCE,
                                               GATED_SOURCE, SEQKV_SOURCE,
                                               CACHE_SOURCE, PURITY_SOURCE)):
        print(f"chip_fault_check: no {KERNEL}, {GRAM_KERNEL}, {DQ_KERNEL} "
              f"or {LORA_KERNEL} beside {__file__}", file=sys.stderr)
        return 1
    _copy(COPY)
    (COPY / KERNEL).write_text(plant_fault((ROOT / KERNEL).read_text()))
    (COPY / GRAM_KERNEL).write_text(
        plant_gram_fault((ROOT / GRAM_KERNEL).read_text()))
    _copy(DQ_COPY)
    (DQ_COPY / DQ_KERNEL).write_text(
        plant_dequant_fault((ROOT / DQ_KERNEL).read_text()))
    _copy(LORA_COPY)
    (LORA_COPY / LORA_KERNEL).write_text(
        plant_lora_fault((ROOT / LORA_KERNEL).read_text()))
    _copy(DIST_COPY)
    (DIST_COPY / DIST_SOURCE).write_text(
        plant_dist_fault((ROOT / DIST_SOURCE).read_text()))
    _copy(SHARDED_COPY)
    (SHARDED_COPY / SHARDED_SOURCE).write_text(
        plant_sharded_fault((ROOT / SHARDED_SOURCE).read_text()))
    _copy(GATED_COPY)
    (GATED_COPY / GATED_SOURCE).write_text(
        plant_gated_fault((ROOT / GATED_SOURCE).read_text()))
    _copy(SEQKV_COPY)
    (SEQKV_COPY / SEQKV_SOURCE).write_text(
        plant_seqkv_fault((ROOT / SEQKV_SOURCE).read_text()))
    _copy(CACHE_COPY)
    (CACHE_COPY / CACHE_SOURCE).write_text(
        plant_cache_fault((ROOT / CACHE_SOURCE).read_text()))
    _copy(PURITY_COPY)
    (PURITY_COPY / PURITY_SOURCE).write_text(
        plant_purity_fault((ROOT / PURITY_SOURCE).read_text()))
    built = ROOT / "build" / "repro_torch"
    if built.is_dir():        # the same CUDA sources: reuse their build
        for copy in (DIST_COPY, SHARDED_COPY, GATED_COPY, SEQKV_COPY,
                     CACHE_COPY, PURITY_COPY):
            shutil.copytree(built, copy / "build" / "repro_torch")
    rows = {}
    for name, tree, which in (("sources", ROOT, "kernels"),
                              ("fault", COPY, "kernels"),
                              ("sources", ROOT, "logits"),
                              ("fault_dequant", DQ_COPY, "logits"),
                              ("sources", ROOT, "lora"),
                              ("fault_lora", LORA_COPY, "lora"),
                              ("sources", ROOT, "dist"),
                              ("fault_dist", DIST_COPY, "dist"),
                              ("sources", ROOT, "sharded"),
                              ("fault_sharded", SHARDED_COPY,
                               "sharded_families"),
                              ("fault_gated", GATED_COPY, "gated"),
                              ("fault_seqkv", SEQKV_COPY, "seqkv"),
                              ("sources", ROOT, "analysis"),
                              ("fault_purity", PURITY_COPY, "analysis"),
                              ("sources", ROOT, "compile_cache"),
                              ("fault_cache", CACHE_COPY, "compile_cache")):
        proc = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree), which],
            capture_output=True, text=True, cwd=ROOT, timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        # a case's row names its kernel; the phases' own lines do not
        got = [r for r in map(json.loads, proc.stdout.splitlines())
               if "kernel" in r]
        rows.setdefault(name, []).extend(got)
        for row in got:
            print(json.dumps({"tree": name, **row}), flush=True)
    import chip_smoke as cs
    sound = all(r["passes"] and r.get("passes_f32_tol", True)
                for r in rows["sources"])
    flash_seen = all(not r["passes"] for r in rows["fault"]
                     if r["kernel"] == "flash_attention"
                     and r["q_scale"] == cs.FLASH_Q_PEAK and r["Sk"] == 4096)
    partial_seen = partial_caught(rows["fault"])
    gram_seen = all(not r["passes"] for r in rows["fault"]
                    if r["kernel"] == "gram" and r["T"] > 64)
    dequant_seen = bool(rows["fault_dequant"]) and all(
        not r["passes"] for r in rows["fault_dequant"])
    lora_seen = bool(rows["fault_lora"]) and all(
        not r["passes"] for r in rows["fault_lora"])
    dist_seen = bool(rows["fault_dist"]) and all(
        "lora_ab" in r["failed_fields"] for r in rows["fault_dist"])
    sharded_seen = bool(rows["fault_sharded"]) and all(
        f"{SHARDED_FAMILY}:grad" in r["failed_checks"]
        for r in rows["fault_sharded"])
    gated_seen = gated_caught(rows["fault_gated"])
    seqkv_seen = seqkv_caught(rows["fault_seqkv"])
    purity_seen = purity_caught(rows["fault_purity"])
    cache_seen = cache_caught(rows["fault_cache"])
    print(json.dumps({"sources_pass": sound, "fault_caught_at_4096": flash_seen,
                      "fault_caught_at_partial_shard": partial_seen,
                      "gram_fault_caught": gram_seen,
                      "dequant_fault_caught_by_logits": dequant_seen,
                      "lora_fault_caught_by_precision": lora_seen,
                      "dist_fault_caught_on_lora_ab": dist_seen,
                      "sharded_fault_caught_on_grads": sharded_seen,
                      "gated_norm_fault_caught": gated_seen,
                      "seqkv_combine_fault_caught_on_logits": seqkv_seen,
                      "purity_fault_caught_by_analysis": purity_seen,
                      "cache_fault_caught_by_compile_cache": cache_seen}))
    return 0 if (sound and flash_seen and partial_seen and gram_seen
                 and dequant_seen and lora_seen and dist_seen and sharded_seen
                 and gated_seen and seqkv_seen and purity_seen
                 and cache_seen) else 1


if __name__ == "__main__":
    sys.exit(main())
