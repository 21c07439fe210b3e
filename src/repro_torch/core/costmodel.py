"""Flops/bytes/collective cost model for the bucket planner.

Twin of ``repro.core.costmodel``.  The planner's divisibility gate
(``n % k == 0`` => shard) alone can pick a slower path: at small widths a
sharded LoftQ bucket pays one ``(L, m, m)`` all-reduce an AltMin round for
little saved compute.  This module predicts each candidate path's time:

* **replicated** -- one stacked call on the rank's device,
* **sharded**    -- every rank runs its ``n / k`` columns: compute and
  memory traffic divide by ``k``, the method's Gram-trick all-reduces
  (CLoQ: one a bucket, LoftQ: one an AltMin round) are added back,
* **sequential** -- ``L`` single-slice calls; never faster under this
  model's linear terms, but chosen when the stacked working set exceeds
  the calibrated memory budget.

Its inputs are a one-time per-host measurement (:func:`calibrate`), cached
to disk (``REPRO_COSTCAL`` or ``~/.cache/repro/``) in the JAX package's
JSON, so each package loads the other's file, and each bucket's per-layer
FLOP and byte counts.  The JAX twin reads those from XLA's
``cost_analysis`` of the traced bucket and falls back to the closed form
:func:`analytic_layer_costs`; PyTorch has no counterpart of XLA's count
(and ``FlopCounterMode`` does not count ``eigh``/``svd``), so the closed
form is this module's default.  Decisions are deterministic given a
calibration: no timing at plan time.

>>> cal = CostCalibration(flops_per_s=1e9, bytes_per_s=1e9,
...                       dispatch_s=1e-3, psum_latency_s=5e-3,
...                       psum_bytes_per_s=1e8, shard_efficiency=2.0)
>>> model = CostModel(cal, layer_costs=lambda s: (8.0 * s.m * s.m * s.n,
...                                               4.0 * s.m * s.n))
>>> model.decide_geometry("loftq", m=64, n=64, L=16, k=2)[0]
'replicated'
>>> model.decide_geometry("cloq", m=2048, n=2048, L=16, k=2)[0]
'sharded'
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Callable

import torch

# execution paths a bucket can take (BucketSpec.exec_path values)
EXEC_PATHS = ("replicated", "sharded", "sequential")

# Gram-trick all-reduces of a sharded bucket: CLoQ does one (L, m, m)
# all-reduce in cloq_lowrank_local, LoftQ one an AltMin round (iters=5)
PSUM_ROUNDS = {"cloq": 1, "loftq": 5}

CAL_ENV = "REPRO_COSTCAL"


@dataclasses.dataclass(frozen=True)
class CostCalibration:
    """Per-host machine constants the cost model reads: measured by
    :func:`calibrate` or loaded from a JSON file (tests write fake tables,
    so decisions are deterministic).  ``jax_version`` is kept for the JAX
    package's files; this package writes ``torch_version``."""
    flops_per_s: float            # dense matmul throughput
    bytes_per_s: float            # streaming memory bandwidth
    dispatch_s: float             # fixed cost of one dispatch
    psum_latency_s: float         # fixed latency of one all-reduce
    psum_bytes_per_s: float       # all-reduce payload bandwidth
    # aggregate speedup of a column-sharded matmul over the same matmul on
    # one rank: ~k on k real cards, ~1 when the ranks share one device
    shard_efficiency: float = 1.0
    memory_budget_bytes: float = math.inf   # stacked-bucket working set cap
    backend: str = "cpu"
    jax_version: str = ""
    n_devices: int = 1
    source: str = "default"       # "measured" | "file" | "default"
    torch_version: str = ""

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = dataclasses.asdict(self)
        # JSON has no inf: the unbounded budget is stored as null
        if math.isinf(payload["memory_budget_bytes"]):
            payload["memory_budget_bytes"] = None
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(
            os.path.abspath(path)), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CostCalibration":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("memory_budget_bytes") is None:
            payload["memory_budget_bytes"] = math.inf
        known = {f.name for f in dataclasses.fields(cls)}
        payload = {k: v for k, v in payload.items() if k in known}
        payload["source"] = "file"
        return cls(**payload)


def _backend_name() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def default_calibration_path() -> str:
    """Where the one-time calibration lives: ``$REPRO_COSTCAL`` when set,
    else a file a (backend, torch version) under ``~/.cache/repro``."""
    env = os.environ.get(CAL_ENV)
    if env:
        return env
    cache = os.environ.get("XDG_CACHE_HOME",
                           os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "repro", f"costcal-torch-{_backend_name()}-"
                        f"{torch.__version__.replace('+', '_')}.json")


def load_calibration(path: str | None = None) -> CostCalibration | None:
    """The calibration at ``path`` (default :func:`default_calibration_path`)
    if there is a readable one, else ``None``."""
    path = path or default_calibration_path()
    try:
        return CostCalibration.load(path)
    except (FileNotFoundError, json.JSONDecodeError, TypeError, ValueError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_wall(thunk, device: torch.device, reps: int = 3) -> float:
    """Best wall seconds of ``thunk()`` over ``reps`` runs, each fenced by a
    device synchronize (a dispatch's whole cost, host included)."""
    best = math.inf
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        thunk()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _best_device(thunk, device: torch.device, reps: int = 3) -> float:
    """Best device seconds of ``thunk()``: CUDA events on the card, a
    fenced wall clock on the CPU."""
    if device.type != "cuda":
        return _best_wall(thunk, device, reps)
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _time_all_reduce(side: int, group, device: torch.device,
                     reps: int = 3) -> float:
    """Best seconds of one all-reduce of a ``(side, side)`` f32 tensor over
    ``group``, every rank fenced by a barrier first."""
    import torch.distributed as dist
    x = torch.zeros((side, side), dtype=torch.float32, device=device)
    dist.all_reduce(x, group=group)  # reprolint: disable=COLLECTIVE (calibration probe: warm-up)
    best = math.inf
    for _ in range(reps):
        _sync(device)
        dist.barrier(group=group)  # reprolint: disable=COLLECTIVE (calibration probe)
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)  # reprolint: disable=COLLECTIVE (calibration probe)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(mesh=None, *, path: str | None = None, force: bool = False,
              device: str | torch.device | None = None) -> CostCalibration:
    """One-time per-host measurement, cached to ``path`` (default
    :func:`default_calibration_path`) so later processes load the table.

    Measures on ``device`` (CUDA by default): dense f32 matmul throughput
    and streaming bytes/s (CUDA events), the cost of one small dispatch
    (fenced wall clock), and with a mesh of more than one rank the
    all-reduce's latency and bytes/s over the model axis's group (solved
    from two payload sizes) and the column-sharded matmul's aggregate
    speedup.  Under a mesh every rank takes part; rank 0's table is
    broadcast so every rank plans with the same numbers, and rank 0 alone
    writes the file.  ``force=True`` measures again."""
    import torch.distributed as dist

    from repro_torch.models import parallel
    from repro_torch.utils import resolve_device

    path = path or default_calibration_path()
    multi = mesh is not None and parallel.axis_size(
        mesh, mesh.mesh_dim_names[0]) > 1
    if not force:
        cal = load_calibration(path)
        if cal is not None:
            return cal
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((1024, 1024), generator=gen).to(dev)
    _ = a @ a                                           # warm-up
    t_mm = _best_device(lambda: a @ a, dev)
    flops_per_s = 2 * 1024 ** 3 / max(t_mm, 1e-9)
    big = torch.zeros((16 * 1024 * 1024,), dtype=torch.float32, device=dev)
    _ = big + 1.0
    t_st = _best_device(lambda: big + 1.0, dev)
    bytes_per_s = 2 * big.numel() * 4 / max(t_st, 1e-9)
    tiny = torch.zeros((1,), dtype=torch.float32, device=dev)
    _ = tiny + 1.0
    dispatch_s = _best_wall(lambda: tiny + 1.0, dev, reps=5)
    del big

    psum_latency_s = dispatch_s
    psum_bytes_per_s = bytes_per_s
    shard_efficiency = 1.0
    n_devices = 1
    if multi:
        axis = mesh.mesh_dim_names[0]
        group = parallel.axis_group(mesh, axis)
        n_devices = parallel.axis_size(mesh, axis)
        t_small, small = _time_all_reduce(64, group, dev), 64 * 64 * 4
        t_large, large = _time_all_reduce(1024, group, dev), 1024 * 1024 * 4
        psum_latency_s = max(t_small - small * (t_large - t_small)
                             / max(large - small, 1), 1e-9)
        psum_bytes_per_s = max((large - small)
                               / max(t_large - t_small, 1e-9), 1.0)
        # aggregate speedup of column-sharding a matmul over the mesh: all
        # ranks run their shard at once, then rank 0 runs the whole
        w = torch.randn((1024, 2048), generator=gen).to(dev)
        w_l = parallel.local_slice(w, (None, axis), mesh).contiguous()

        def sharded():
            dist.barrier(group=group)  # reprolint: disable=COLLECTIVE (calibration probe)
            _ = w_l @ w_l.mT @ w_l
            _sync(dev)
            dist.barrier(group=group)  # reprolint: disable=COLLECTIVE (calibration probe)

        sharded()
        t_sh = _best_wall(sharded, dev)
        t_rep = math.inf
        if parallel.axis_rank(mesh, axis) == 0:
            _ = w @ w.mT @ w
            t_rep = _best_wall(lambda: w @ w.mT @ w, dev)
        dist.barrier(group=group)  # reprolint: disable=COLLECTIVE (calibration probe)
        shard_efficiency = min(max(t_rep / max(t_sh, 1e-9), 1e-2),
                               float(n_devices))

    cal = CostCalibration(
        flops_per_s=flops_per_s, bytes_per_s=bytes_per_s,
        dispatch_s=dispatch_s, psum_latency_s=psum_latency_s,
        psum_bytes_per_s=psum_bytes_per_s,
        shard_efficiency=shard_efficiency, backend=dev.type,
        n_devices=n_devices, source="measured",
        torch_version=torch.__version__)
    if multi:
        box = [cal]
        group = parallel.axis_group(mesh, axis)
        dist.broadcast_object_list(  # reprolint: disable=COLLECTIVE (the calibration to every rank, once)
            box, src=dist.get_global_rank(group, 0), group=group)
        cal = box[0]
        if parallel.axis_rank(mesh, axis) != 0:
            return cal
    try:
        cal.save(path)
    except OSError:
        pass                      # read-only cache dir: keep it in memory
    return cal


def analytic_layer_costs(method: str, m: int, n: int, rank: int,
                         has_gram: bool) -> tuple[float, float]:
    """Closed-form per-layer FLOP/byte estimate (the JAX twin's fallback,
    this package's default).  Deliberately coarse: the OPTQ column sweep
    is ~``m^2 n`` MACs, the eigh/SVD factorizations ~``m^3``, the LoRA
    products ~``m n r``."""
    flops = 8.0 * m * m * n + 30.0 * m ** 3 + 6.0 * m * n * rank
    bytes_ = 4.0 * (3 * m * n + (2 * m * m if has_gram else 0)
                    + 2 * (m + n) * rank)
    return flops, bytes_


def spec_layer_costs(spec) -> tuple[float, float]:
    """:func:`analytic_layer_costs` of a spec-like object (``.method .m .n
    .rank .has_gram``): the default ``layer_costs`` of :class:`CostModel`."""
    return analytic_layer_costs(spec.method, spec.m, spec.n, spec.rank,
                                spec.has_gram)


class CostModel:
    """Predicted-time path chooser for one bucket.

    ``layer_costs`` maps a :class:`~repro_torch.core.batched.BucketSpec`-
    like object (``.m .n .method .rank .has_gram``) to per-layer ``(flops,
    bytes)``; default :func:`spec_layer_costs`.  Every decision is
    arithmetic over the calibration table: no timing, deterministic."""

    def __init__(self, calibration: CostCalibration, *,
                 layer_costs: Callable | None = None):
        self.calibration = calibration
        self._layer_costs = layer_costs or spec_layer_costs
        self._cost_cache: dict = {}

    @classmethod
    def coerce(cls, obj) -> "CostModel | None":
        """Accept a CostModel, a CostCalibration, a calibration-file path,
        or ``None`` (no cost model: the divisibility-only planner)."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, CostCalibration):
            return cls(obj)
        if isinstance(obj, (str, os.PathLike)):
            cal = load_calibration(os.fspath(obj))
            if cal is None:
                raise FileNotFoundError(
                    f"no cost calibration at {obj!r} — run "
                    "repro_torch.core.costmodel.calibrate(path=...) once")
            return cls(cal)
        raise TypeError(f"cannot coerce {type(obj).__name__} to CostModel")

    def layer_costs(self, spec) -> tuple[float, float]:
        k = (spec.method, spec.m, spec.n, spec.rank, spec.has_gram,
             getattr(spec, "bits", None), getattr(spec, "group_size", None))
        if k not in self._cost_cache:
            self._cost_cache[k] = self._layer_costs(spec)
        return self._cost_cache[k]

    def path_times(self, spec, L: int, k: int) -> dict:
        """Predicted seconds of each candidate path for an ``L``-layer
        bucket on a ``k``-rank axis; ``sharded`` only when the
        divisibility gate allows it (``k > 1`` and ``n % k == 0``).  The
        sharded estimate takes the layer cost at the shard width ``n / k``
        (the ``m``-dimension work, ``eigh`` and the Gram root, does not
        divide)."""
        cal = self.calibration
        f, by = self.layer_costs(spec)
        compute = L * f / cal.flops_per_s + L * by / cal.bytes_per_s
        times = {"replicated": compute + cal.dispatch_s,
                 "sequential": compute + L * cal.dispatch_s}
        if k > 1 and spec.n % k == 0:
            local = dataclasses.replace(spec, n=spec.n // k)
            f_l, by_l = self.layer_costs(local)
            # each shard's rate: the measured shard efficiency spread over
            # k shards (ranks sharing one device: ~1/k each)
            rate = max(cal.shard_efficiency, 1e-3) / k
            local_compute = (L * f_l / (cal.flops_per_s * rate)
                             + L * by_l / (cal.bytes_per_s * rate))
            rounds = PSUM_ROUNDS.get(spec.method, 0)
            psum_payload = rounds * L * spec.m * spec.m * 4.0
            times["sharded"] = (local_compute + cal.dispatch_s
                                + rounds * cal.psum_latency_s
                                + psum_payload / cal.psum_bytes_per_s)
        return times

    def decide(self, spec, L: int, k: int) -> tuple[str, int]:
        """``(exec_path, n_shards)`` of one bucket from predicted time; a
        stacked working set over the memory budget runs sequentially."""
        _, by = self.layer_costs(spec)
        if L * by > self.calibration.memory_budget_bytes:
            return "sequential", 1
        times = self.path_times(spec, L, k)
        best = min(EXEC_PATHS, key=lambda p: times.get(p, math.inf))
        return best, (k if best == "sharded" else 1)

    def decide_geometry(self, method: str, *, m: int, n: int, L: int,
                        k: int, rank: int = 16,
                        has_gram: bool | None = None) -> tuple[str, int]:
        """:meth:`decide` from raw geometry (no BucketSpec): what the
        manifest restore uses."""
        geo = _Geometry(m=m, n=n, method=method, rank=rank,
                        has_gram=(method in ("cloq", "gptq")
                                  if has_gram is None else has_gram))
        return self.decide(geo, L, k)

    def explain(self, spec, L: int, k: int) -> str:
        times = self.path_times(spec, L, k)
        parts = ", ".join(f"{p}={times[p] * 1e3:.2f}ms"
                          for p in EXEC_PATHS if p in times)
        path, shards = self.decide(spec, L, k)
        return (f"{spec.method} {spec.m}x{spec.n} x{L} on k={k}: {parts} "
                f"-> {path}" + (f" x{shards}" if shards > 1 else ""))


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """Minimal spec-shaped record for :meth:`CostModel.decide_geometry`."""
    m: int
    n: int
    method: str
    rank: int
    has_gram: bool
    bits: int | None = None
    group_size: int | None = None
