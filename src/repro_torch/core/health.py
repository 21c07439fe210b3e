"""Numerical health guards and the degradation ladder of the quantization
engines.

PyTorch twin of ``repro.core.health``.  One ill-conditioned Gram is enough
to sink a quantization pass: OPTQ's damped Cholesky turns a non-PSD Gram
into NaN (:mod:`repro_torch.core.linalg` keeps JAX's NaN where
``torch.linalg`` would raise), the NaN rides the error-compensation sweep
into every code of the layer, and ``W - Qd`` poisons the CLoQ solve.

**Per-bucket check** (:func:`check_bucket`, :func:`check_single`).  After
each bucket the engine checks every slice at once: every produced leaf
finite, and the residual ``||W - Qd - A B^T||_F^2`` (with ``Qd`` read back
from the stored leaves, so the pack/unpack round trip is checked too) at
most ``blowup_factor`` times that of a data-free RTN round trip of the same
weight at the same bits.

**Degradation ladder** (:func:`heal_task`).  A failing slice is requeued
through the single-site core (:func:`repro_torch.core.batched.
quantize_single_deq`) under growing rungs, each accepted only when its
output is finite and its calibration-weighted error ``tr(E^T H E)`` stays
within the blowup bound of the RTN baseline's: (1) re-damp with growing
``lambda_frac``; (2) the identity Gram ``tr(H)/m * I``; (3) RTN at the
same bits (not for NF4-coded ``qlora``); (4) skip to dense (``None``).
Every rung, its errors and the diagnosis of the failure land in a
per-site :class:`HealthReport`, whose JSON is the reference's.

Both engines heal through the same single-site core with the slice's own
``(W, H, key, spec)``, so a healed site is bit-identical across engines.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.batched import (BucketSpec, eval_single,
                                      quantize_single_deq, requeue_spec)
from repro_torch.core.optq import cholesky_factor_finite
from repro_torch.core.quantizer import (dequantize_int, dequantize_nf4,
                                        quantize_int, quantize_nf4,
                                        unpack_codes)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor


class QuantPreempted(RuntimeError):
    """Raised by the engine at a bucket boundary when the caller's
    ``should_stop`` fires (SIGTERM during quantization).  Completed buckets
    are already committed to the journal; ``bucket`` is the last one."""

    def __init__(self, bucket: int):
        super().__init__(f"quantization preempted after bucket {bucket}")
        self.bucket = bucket


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Guard thresholds and the ladder's schedule.

    ``blowup_factor``: a slice fails when its residual error exceeds this
    multiple of the data-free RTN round trip's at the same bits.
    ``redamp_fracs``: the growing ``lambda_frac`` of ladder rung 1 (the
    engine default is 0.01)."""
    enabled: bool = True
    blowup_factor: float = 10.0
    abs_tol: float = 1e-8
    redamp_fracs: tuple[float, ...] = (0.05, 0.25)


class HealthReport:
    """Per-site record of every health decision of one quantization run.

    ``records`` maps a site key (``path`` or ``path[expert]``) to the
    outcome of its ladder walk; sites that pass the check are only counted
    (``checked``).  ``events`` collects run-level notes (skipped
    calibration batches, journal restores)."""

    def __init__(self) -> None:
        self.records: dict[str, dict] = {}
        self.events: list[str] = []
        self.checked: int = 0

    @staticmethod
    def site_key(path: str, expert: int | None = None) -> str:
        return path if expert is None else f"{path}[{expert}]"

    def event(self, msg: str) -> None:
        self.events.append(msg)

    def record(self, path: str, expert: int | None, status: str, *,
               ladder: tuple | list = (), diagnosis: dict | None = None,
               detail: str = "") -> None:
        site = self.site_key(path, expert)
        self.records[site] = {
            "status": status, "ladder": list(ladder),
            "diagnosis": diagnosis, "detail": detail}
        obs_metrics.counter(obs_names.HEALTH_PREFIX + status).inc()
        obs_trace.instant("health." + status, site=site)

    def fallbacks(self) -> dict[str, dict]:
        """Sites that did not come out of the bucket's own call clean."""
        return dict(self.records)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records.values():
            out[r["status"]] = out.get(r["status"], 0) + 1
        return out

    def to_dict(self) -> dict:
        return {"checked": self.checked, "counts": self.counts(),
                "records": self.records, "events": self.events}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    def summary(self) -> str:
        c = self.counts()
        if not c and not self.events:
            return f"health: {self.checked} slices checked, all clean"
        parts = [f"{v}x {k}" for k, v in sorted(c.items())]
        return (f"health: {self.checked} slices checked, "
                + (", ".join(parts) if parts else "all clean")
                + (f"; {len(self.events)} event(s)" if self.events else ""))


# ---------------------------------------------------------------------------
# The per-bucket check.
# ---------------------------------------------------------------------------


def _leaves_dequant(leaves: dict, spec: BucketSpec) -> Tensor:
    """Dequantized base from the stored leaves (one slice or a stack):
    what ``linear_apply`` would read."""
    if spec.method == "qlora":
        codes = unpack_codes(leaves["qcodes"], 4, spec.m)
        return dequantize_nf4(codes, leaves["absmax"], spec.group_size)
    codes = unpack_codes(leaves["qcodes"], spec.bits, spec.m)
    return dequantize_int(codes, leaves["scales"], leaves["zeros"],
                          spec.group_size)


def _rtn_dequant(W: Tensor, spec: BucketSpec) -> Tensor:
    """Data-free RTN round trip of ``W`` at the slice's own format: the
    blowup baseline (finite for finite ``W``: scales are floored)."""
    if spec.method == "qlora":
        codes, absmax = quantize_nf4(W, spec.group_size)
        return dequantize_nf4(codes, absmax, spec.group_size)
    codes, s, z = quantize_int(W, spec.bits, spec.group_size)
    return dequantize_int(codes, s, z, spec.group_size)


def _finite_leaves(leaves: dict) -> Tensor:
    """Per slice: every floating leaf finite (shape ``W.shape[:-2]``)."""
    ok = None
    for k in sorted(leaves):
        v = leaves[k]
        if v.is_floating_point():
            f = torch.isfinite(v).all(dim=-1).all(dim=-1)
            ok = f if ok is None else ok & f
    return ok


def _check(W: Tensor, leaves: dict, spec: BucketSpec):
    W = W.float()
    finite = _finite_leaves(leaves)
    E = W - _leaves_dequant(leaves, spec) - \
        leaves["lora_a"].float() @ leaves["lora_b"].float().mT
    err = (E * E).sum(dim=(-2, -1))
    R = W - _rtn_dequant(W, spec)
    return finite, err, (R * R).sum(dim=(-2, -1))


def check_bucket(Ws: Tensor, leaves: dict, spec: BucketSpec,
                 policy: HealthPolicy, group=None) -> np.ndarray:
    """Health flags of one executed bucket: ``(L,)`` bool, True = the slice
    is clean.  The blowup comparison happens on the host in f64.  With
    ``group`` ``Ws`` and the leaves are a rank's column shard: each slice's
    errors and non-finite count are summed over the ranks (one all-reduce),
    so every rank reaches the same flags."""
    finite, err, rerr = _check(Ws, leaves, spec)
    if group is not None:
        from repro_torch.models.parallel import all_reduce_sum
        tot = all_reduce_sum(torch.stack([(~finite).double(), err.double(),
                                          rerr.double()]), group)
        finite, err, rerr = tot[0] == 0, tot[1], tot[2]
    finite = finite.cpu().numpy()
    err = err.double().cpu().numpy()
    rerr = rerr.double().cpu().numpy()
    return (finite & np.isfinite(err)
            & (err <= policy.blowup_factor * rerr + policy.abs_tol))


def check_single(W: Tensor, leaves: dict, spec: BucketSpec,
                 policy: HealthPolicy) -> bool:
    """The sequential engine's per-layer guard: :func:`check_bucket`'s
    criterion on one slice."""
    finite, err, rerr = _check(W, leaves, spec)
    err = float(err)
    return bool(finite) and np.isfinite(err) and \
        err <= policy.blowup_factor * float(rerr) + policy.abs_tol


# ---------------------------------------------------------------------------
# Diagnosis and the degradation ladder.
# ---------------------------------------------------------------------------


def diagnose(W: Tensor, H: Tensor | None, spec: BucketSpec) -> dict:
    """Which ingredient of a failing slice is bad.  ``cholesky_finite``
    names the classic OPTQ failure: a finite but (effectively) non-PSD Gram
    whose damped Cholesky factor is NaN."""
    out: dict[str, Any] = {"w_finite": bool(torch.isfinite(W).all()),
                           "gram": None}
    if spec.has_gram and H is not None:
        g_ok = bool(torch.isfinite(H).all())
        out["gram"] = {"finite": g_ok,
                       "cholesky_finite":
                           cholesky_factor_finite(H, spec.lambda_frac)
                           if g_ok else False}
    return out


def identity_gram(H: Tensor | None, m: int, device=None) -> Tensor:
    """The data-free stand-in Gram of ladder rung 2: ``tr(H)/m * I`` (the
    trace summed in f64), plain ``I`` when the trace is unusable."""
    scale = 1.0
    if H is not None:
        tr = float(torch.diagonal(H).double().sum())
        if np.isfinite(tr) and tr > 0:
            scale = tr / m
        device = H.device
    return torch.eye(m, dtype=torch.float32, device=device) * \
        np.float32(scale).item()


def _attempt(W: Tensor, H: Tensor | None, key: int, spec: BucketSpec):
    """One rung: quantize, then finiteness and the calibration-weighted
    errors of the candidate and of its RTN baseline."""
    leaves, Qd = quantize_single_deq(W, H, key, spec)
    finite = bool(_finite_leaves(leaves))
    E = W.float() - Qd - leaves["lora_a"] @ leaves["lora_b"].mT
    if spec.has_gram:
        err = torch.einsum("ij,ik,kj->", E, H.float(), E)
    else:
        err = (E * E).sum()
    rtn_spec = dataclasses.replace(spec, method="rtn", magr=False)
    rerr = eval_single(W, H, key, rtn_spec)
    return leaves, finite, float(err), float(rerr)


def _try_rung(W, H, key, spec: BucketSpec, policy: HealthPolicy,
              name: str, steps: list):
    leaves, finite, err, rerr = _attempt(W, H, key, spec)
    ok = finite and np.isfinite(err) and \
        err <= policy.blowup_factor * rerr + policy.abs_tol
    steps.append({"rung": name, "accepted": bool(ok), "err": err,
                  "rtn_err": rerr})
    return leaves if ok else None


def heal_task(W: Tensor, H: Tensor | None, key: int, spec: BucketSpec,
              policy: HealthPolicy, report: HealthReport, path: str,
              expert: int | None = None) -> dict | None:
    """Walk the degradation ladder for one failing slice.

    Returns the accepted leaf dict, or ``None`` for skip-to-dense (the
    caller leaves the dense ``w`` in place).  Raises ``FloatingPointError``
    when the weight itself is non-finite: that is corrupt input, not a
    numerical cliff.  One ``health.heal`` span (``repro_torch.obs``)."""
    with obs_trace.span("health.heal",
                        site=HealthReport.site_key(path, expert),
                        method=spec.method) as sp:
        out = _heal_ladder(W, H, key, spec, policy, report, path, expert)
        sp.set(healed=out is not None)
        return out


def _heal_ladder(W: Tensor, H: Tensor | None, key: int, spec: BucketSpec,
                 policy: HealthPolicy, report: HealthReport, path: str,
                 expert: int | None = None) -> dict | None:
    if not bool(torch.isfinite(W).all()):
        raise FloatingPointError(
            f"weight at {HealthReport.site_key(path, expert)} contains "
            "non-finite values — unrecoverable (corrupt input params)")
    diag = diagnose(W, H, spec)
    spec = requeue_spec(spec)
    steps: list[dict] = []
    gram_finite = bool(diag["gram"] and diag["gram"]["finite"])

    if spec.has_gram and gram_finite:
        for f in policy.redamp_fracs:
            out = _try_rung(W, H, key,
                            dataclasses.replace(spec, lambda_frac=f),
                            policy, f"redamp({f})", steps)
            if out is not None:
                report.record(path, expert, "recovered_redamp",
                              ladder=steps, diagnosis=diag,
                              detail=f"lambda_frac={f}")
                return out
    if spec.has_gram:
        H_id = identity_gram(H, spec.m, W.device)
        out = _try_rung(W, H_id, key, spec, policy, "identity_gram", steps)
        if out is not None:
            report.record(path, expert, "recovered_identity_gram",
                          ladder=steps, diagnosis=diag,
                          detail="calibration Gram replaced by tr(H)/m * I")
            return out
    if spec.method != "qlora":
        # same bits, group and leaf structure; NF4 (qlora) stores absmax
        # instead of scales/zeros, so it cannot take this rung
        rtn_spec = dataclasses.replace(spec, method="rtn", has_gram=False,
                                       magr=False)
        out = _try_rung(W, None, key, rtn_spec, policy, "rtn", steps)
        if out is not None:
            report.record(path, expert, "fallback_rtn", ladder=steps,
                          diagnosis=diag,
                          detail=f"data-free RTN at {spec.bits} bits")
            return out
    report.record(path, expert, "fallback_dense", ladder=steps,
                  diagnosis=diag, detail="site left dense")
    return None


def heal_site_lora(H_site: Tensor, dW: Tensor, rank: int, split: str,
                   policy: HealthPolicy, report: HealthReport,
                   path: str, site_path: str):
    """Ladder for one per-site adapter pair of a weight-shared block: the
    base is healthy, only the per-site CLoQ solve failed.  Rungs: re-damp
    the site Gram, the identity Gram (plain SVD of ``dW``), zero adapters
    (the site uses the shared base alone)."""
    from repro_torch.core.cloq import cloq_init, regularize_gram

    dW = dW.float()
    m, n = dW.shape
    steps: list[dict] = []

    def finite_pair(A, B):
        return bool(torch.isfinite(A).all()) and bool(torch.isfinite(B).all())

    if bool(torch.isfinite(H_site).all()):
        for f in policy.redamp_fracs:
            A, B = cloq_init(regularize_gram(H_site.float(), f), dW, rank,
                             split)
            ok = finite_pair(A, B)
            steps.append({"rung": f"redamp({f})", "accepted": ok})
            if ok:
                report.record(path, None, "recovered_redamp", ladder=steps,
                              detail=f"site adapter {site_path}, "
                                     f"lambda_frac={f}")
                return A, B
    A, B = cloq_init(identity_gram(H_site, m), dW, rank, split)
    ok = finite_pair(A, B)
    steps.append({"rung": "identity_gram", "accepted": ok})
    if ok:
        report.record(path, None, "recovered_identity_gram", ladder=steps,
                      detail=f"site adapter {site_path}: plain SVD of dW")
        return A, B
    steps.append({"rung": "zero_adapters", "accepted": True})
    report.record(path, None, "fallback_zero_adapters", ladder=steps,
                  detail=f"site adapter {site_path} zeroed — site uses the "
                         "shared base alone")
    return (dW.new_zeros((m, rank)), dW.new_zeros((n, rank)))
