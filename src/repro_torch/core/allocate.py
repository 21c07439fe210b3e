"""Calibrated bit allocation: sensitivity sweep -> budgeted recipe solver.

PyTorch twin of ``repro.core.allocate``.  Given a grid of per-site
candidates (method x bits x LoRA rank) and a total byte budget, it derives
the :class:`~repro_torch.core.recipe.QuantRecipe` that minimizes the
model's total calibration-weighted quantization error (the LQ-LoRA idea,
Guo et al., arXiv:2311.12023, on CLoQ's calibration Grams).

**Stage 1: the sensitivity sweep** (:func:`sweep_sensitivity`).  Every
quantization site is evaluated under every candidate with the proxy

    err(site, cand) = tr(E^T H E),    E = W - Q - A B^T,

the layer-wise discrepancy ``||X E||_F^2`` written through the Gram ``H =
X^T X`` that calibration collects.  One ``(site, candidate)`` pair is one
:class:`~repro_torch.core.batched.LayerTask` carrying the candidate as its
site spec, and the whole list goes through
:func:`repro_torch.core.batched.evaluate_layer_batch` in one call: one
stacked call a ``(shape x candidate)`` bucket chunk.

**Stage 2: the budget solver** (:func:`solve_budget`).  Exact byte
accounting (:func:`site_bytes`, the mirror of ``pipeline.
_quant_leaf_shapes``) feeds a multiple-choice knapsack: each site group
picks one candidate, total bytes <= budget, total proxy error minimized,
by the Lagrangian greedy over each group's lower convex hull in ``(bytes,
err)``; :func:`solve_exhaustive` is the brute-force cross-check.  The
solver is pure Python with the JAX twin's arithmetic, so the same tables
give the same choices.

The chosen plan is emitted as exact-path rules (one layer-uniform glob
rule a site template in scan-stacked containers).

Byte accounting, checked by hand: a 64x32 site at 4-bit, group 16, rank 4
packs two codes a byte (64*32/2 = 1024), stores (64/16)*32 f32 scales and
zeros (2*512) and two f32 rank-4 adapters ((64+32)*4*4 = 1536):

>>> import torch
>>> from repro_torch.core.recipe import SiteSpec
>>> from repro_torch.models.modules import QSpec
>>> site_bytes(64, 32, SiteSpec("cloq", QSpec(bits=4, group_size=16,
...                                           rank=4)), torch.float32)
3584

With ``mesh=`` the sweep's divisible buckets run column-sharded (every rank
of the mesh calling with the same tasks and getting every error, so every
rank solves for the same plan).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core.batched import LayerTask, evaluate_layer_batch
from repro_torch.core.recipe import METHODS, QuantRecipe, SiteRule, SiteSpec
from repro_torch.models.modules import QSpec

# the default candidate grid: {2,3,4}-bit x {gptq, cloq, loftq} x rank in
# {0, 16, 64}
DEFAULT_BITS = (2, 3, 4)
DEFAULT_METHODS = ("gptq", "cloq", "loftq")
DEFAULT_RANKS = (0, 16, 64)


def default_grid(bits: Sequence[int] = DEFAULT_BITS,
                 methods: Sequence[str] = DEFAULT_METHODS,
                 ranks: Sequence[int] = DEFAULT_RANKS
                 ) -> tuple[tuple[str, int, int], ...]:
    """The candidate grid as ``(method, bits, rank)`` tuples.

    >>> len(default_grid())
    27
    >>> default_grid(bits=(2, 4), methods=("cloq",), ranks=(0, 8))
    (('cloq', 2, 0), ('cloq', 2, 8), ('cloq', 4, 0), ('cloq', 4, 8))
    """
    for mth in methods:
        if mth not in METHODS:
            raise ValueError(f"unknown method {mth!r}; options {METHODS}")
    return tuple((mth, b, r) for mth in methods for b in bits for r in ranks)


def candidate_spec(cand, base: QSpec, m: int) -> SiteSpec:
    """One grid entry ``(method, bits, rank)`` (or a :class:`SiteSpec`,
    passed through) as the site spec of a site with ``m`` in-features.
    ``group_size``/``split`` come from ``base``; a group that does not
    divide ``m`` falls back to one group a column (``group_size=m``)."""
    if isinstance(cand, SiteSpec):
        return cand
    method, bits, rank = cand
    g = base.group_size
    if g is None or m % g != 0:
        g = m
    return SiteSpec(method, dataclasses.replace(
        base, method=method, bits=bits, rank=rank, group_size=g))


def site_bytes(m: int, n: int, spec: SiteSpec, dtype=torch.bfloat16,
               experts: int = 1, lora_sites: int = 1) -> int:
    """Serialized bytes of ONE quantization site under ``spec``: the
    ``qcodes`` (2- and 4-bit packed 4 and 2 codes a byte, 3- and 8-bit one
    a byte, NF4 always 4-bit), f32 ``scales`` and ``zeros`` (one f32
    ``absmax`` for qlora) and the LoRA pair in the model dtype.
    ``experts`` multiplies everything (stacked ``(E, m, n)`` leaves),
    ``lora_sites`` only the adapter pair (a weight-shared block keeps one
    base and a pair a site).  ``spec.skip`` costs the dense weight."""
    dsize = torch.tensor([], dtype=dtype).element_size()
    if spec.skip:
        return experts * m * n * dsize
    q = spec.qspec
    g = m if q.group_size is None else q.group_size
    if m % g:
        raise ValueError(f"group {g} does not divide in-features {m}")
    bits = 4 if spec.method == "qlora" else q.bits
    code = (m * bits // 8 if bits in (2, 4) else m) * n
    meta = (m // g) * n * 4 * (1 if spec.method == "qlora" else 2)
    lora = (m + n) * q.rank * dsize
    return experts * (code + meta + lora_sites * lora)


# ---------------------------------------------------------------------------
# Decision groups: one choice a site; a scan-stacked container's sites
# collapse to one layer-uniform choice a site template.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteGroup:
    """One solver decision: a recipe rule pattern, the eager paths it
    covers, their shared geometry, and (after the sweep) the
    per-candidate ``(spec, bytes, err)`` table."""
    pattern: str
    paths: tuple[str, ...]
    m: int
    n: int
    experts: int = 1
    lora_sites: int = 1
    candidates: tuple[SiteSpec, ...] = ()
    bytes_: tuple[int, ...] = ()
    errors: tuple[float, ...] = ()


def _scan_pattern(path: str, stacked: Sequence[str]) -> str | None:
    segs = path.split(".")
    if len(segs) > 2 and segs[0] in stacked and segs[1].isdigit():
        return f"{segs[0]}.*.{'.'.join(segs[2:])}"
    return None


def group_sites(path_meta: dict[str, tuple[int, int, int, int]],
                scan_containers: Sequence[str] = ()) -> list[SiteGroup]:
    """Fold ``{path: (m, n, experts, lora_sites)}`` into decision groups.
    Paths inside a scan-stacked container collapse onto one group
    (pattern ``container.*.rest``), so any emitted recipe is
    layer-uniform by construction."""
    groups: dict[str, SiteGroup] = {}
    for path, (m, n, experts, lora_sites) in path_meta.items():
        pat = _scan_pattern(path, scan_containers) or path
        g = groups.get(pat)
        if g is None:
            groups[pat] = SiteGroup(pat, (path,), m, n, experts, lora_sites)
        else:
            if (m, n, experts, lora_sites) != (g.m, g.n, g.experts,
                                               g.lora_sites):
                raise ValueError(
                    f"scan container sites under {pat!r} disagree on "
                    "geometry — cannot allocate layer-uniformly")
            g.paths = g.paths + (path,)
    return list(groups.values())


# ---------------------------------------------------------------------------
# Stage 1: the sweep.
# ---------------------------------------------------------------------------


def sweep_sensitivity(tasks: list[LayerTask], groups: list[SiteGroup],
                      grid: Iterable, base: QSpec, dtype=torch.bfloat16,
                      *, include_skip: bool = False, mesh=None,
                      axis: str = "model",
                      progress: Callable[[str], None] | None = None
                      ) -> list[SiteGroup]:
    """Fill every group's ``(candidates, bytes_, errors)`` table.

    One eval task a ``(site task x candidate)``, the candidate as its site
    spec; the whole list goes through :func:`evaluate_layer_batch` in one
    call.  A group's error sums its member paths (and MoE expert slices);
    its bytes come from :func:`site_bytes`.  ``include_skip`` appends the
    leave-dense candidate (zero error, dense bytes).  A candidate with a
    non-finite error leaves the table (reported through ``progress``);
    a group left with none raises ``RuntimeError``.  ``mesh``: the sweep's
    divisible buckets run column-sharded over ``axis``
    (``batched.evaluate_layer_batch``)."""
    grid = tuple(grid)
    by_path: dict[str, list[int]] = {}
    for i, t in enumerate(tasks):
        by_path.setdefault(t.path, []).append(i)

    eval_tasks: list[LayerTask] = []
    slots: list[tuple[int, int]] = []          # (group index, candidate idx)
    for gi, g in enumerate(groups):
        specs = [candidate_spec(c, base, g.m) for c in grid]
        if include_skip:
            specs.append(SiteSpec(base.method or "cloq", base, skip=True))
        g.candidates = tuple(specs)
        # a group decision covers every member path (scan-uniform layers)
        g.bytes_ = tuple(
            len(g.paths) *
            site_bytes(g.m, g.n, s, dtype, g.experts, g.lora_sites)
            for s in specs)
        for ci, spec in enumerate(specs):
            if spec.skip:
                continue
            for path in g.paths:
                for ti in by_path[path]:
                    eval_tasks.append(
                        dataclasses.replace(tasks[ti], site=spec))
                    slots.append((gi, ci))

    errs = evaluate_layer_batch(eval_tasks, mesh=mesh, axis=axis,
                                progress=progress)
    acc: dict[tuple[int, int], float] = {}
    for (gi, ci), e in zip(slots, errs):
        acc[(gi, ci)] = acc.get((gi, ci), 0.0) + e
    for gi, g in enumerate(groups):
        errors = tuple(acc.get((gi, ci), 0.0)
                       for ci in range(len(g.candidates)))
        # a non-finite error would corrupt the hull's slope comparisons
        # and could be picked: such a candidate leaves the table
        keep = [ci for ci, e in enumerate(errors) if math.isfinite(e)]
        if not keep:
            raise RuntimeError(
                f"allocation sweep: every candidate of site group "
                f"{g.paths[0]!r} (x{len(g.paths)} paths) produced a "
                "non-finite proxy error — the site's calibration Gram is "
                "unusable at every grid point; re-calibrate, or rerun "
                "with include_skip=True to allow leaving it dense")
        if len(keep) < len(errors):
            if progress:
                progress(f"[sweep] {g.paths[0]}: dropped "
                         f"{len(errors) - len(keep)} non-finite "
                         "candidate(s)")
            g.candidates = tuple(g.candidates[ci] for ci in keep)
            g.bytes_ = tuple(g.bytes_[ci] for ci in keep)
            errors = tuple(errors[ci] for ci in keep)
        g.errors = errors
    return groups


# ---------------------------------------------------------------------------
# Stage 2: the budget solver (multiple-choice knapsack).
# ---------------------------------------------------------------------------


def _hull_chain(bytes_: Sequence[int], errs: Sequence[float]) -> list[int]:
    """Indices of the lower convex hull of ``(bytes, err)`` points: bytes
    ascending, err strictly descending, marginal efficiency ``-d(err) /
    d(bytes)`` non-increasing.  Dominated candidates never appear."""
    order = sorted(range(len(bytes_)), key=lambda j: (bytes_[j], errs[j]))
    stair: list[int] = []
    for j in order:
        if stair and errs[j] >= errs[stair[-1]] - 1e-12:
            continue                            # dominated
        if stair and bytes_[j] == bytes_[stair[-1]]:
            stair.pop()                         # same cost, lower err wins
        stair.append(j)

    def eff(a: int, b: int) -> float:
        return (errs[a] - errs[b]) / max(bytes_[b] - bytes_[a], 1)

    hull: list[int] = []
    for j in stair:
        while len(hull) >= 2 and eff(hull[-1], j) >= eff(hull[-2], hull[-1]):
            hull.pop()
        hull.append(j)
    return hull


def solve_budget(groups: list[SiteGroup], budget_bytes: int) -> list[int]:
    """Greedy Lagrangian MCKP solve: one candidate index a group, total
    bytes <= ``budget_bytes``, total proxy error (approximately)
    minimized.  Every group starts at its cheapest hull point; hull
    upgrades compete on error removed per byte through one priority
    queue, and a group whose next upgrade no longer fits is retired.
    Exact whenever the budget lands on a hull breakpoint
    (:func:`budget_curve`).  Raises ``ValueError`` when even the cheapest
    plan overflows the budget."""
    chains = [_hull_chain(g.bytes_, g.errors) for g in groups]
    choice = [c[0] for c in chains]
    pos = [0] * len(groups)
    spent = sum(g.bytes_[c] for g, c in zip(groups, choice))
    if spent > budget_bytes:
        raise ValueError(
            f"budget {budget_bytes} B infeasible: cheapest plan needs "
            f"{spent} B ({len(groups)} site groups)")

    def push(heap, gi):
        c = chains[gi]
        p = pos[gi]
        if p + 1 >= len(c):
            return
        a, b = c[p], c[p + 1]
        dbytes = groups[gi].bytes_[b] - groups[gi].bytes_[a]
        derr = groups[gi].errors[a] - groups[gi].errors[b]
        heapq.heappush(heap, (-derr / max(dbytes, 1), gi, b, dbytes))

    heap: list = []
    for gi in range(len(groups)):
        push(heap, gi)
    while heap:
        _, gi, b, dbytes = heapq.heappop(heap)
        if pos[gi] + 1 >= len(chains[gi]) or \
                b != chains[gi][pos[gi] + 1]:   # stale entry
            continue
        if spent + dbytes > budget_bytes:
            continue                            # retire this group's chain
        spent += dbytes
        pos[gi] += 1
        choice[gi] = b
        push(heap, gi)
    return choice


def budget_curve(groups: list[SiteGroup]) -> list[tuple[int, float]]:
    """The greedy's ``(total_bytes, total_error)`` trade-off: the start
    point (every group at its cheapest hull candidate) and each upgrade
    in global efficiency order.  Its byte totals are the hull
    breakpoints, budgets at which the greedy is exactly optimal."""
    chains = [_hull_chain(g.bytes_, g.errors) for g in groups]
    spent = sum(g.bytes_[c[0]] for g, c in zip(groups, chains))
    err = sum(g.errors[c[0]] for g, c in zip(groups, chains))
    incs = []
    for gi, (g, c) in enumerate(zip(groups, chains)):
        for p in range(len(c) - 1):
            dbytes = g.bytes_[c[p + 1]] - g.bytes_[c[p]]
            derr = g.errors[c[p]] - g.errors[c[p + 1]]
            incs.append((-derr / max(dbytes, 1), gi, p, dbytes, derr))
    curve = [(spent, err)]
    for _, _, _, dbytes, derr in sorted(incs):
        spent += dbytes
        err -= derr
        curve.append((spent, err))
    return curve


def solve_exhaustive(groups: list[SiteGroup], budget_bytes: int,
                     max_combos: int = 200_000) -> list[int]:
    """Brute-force MCKP optimum: the greedy's oracle on small site
    sets."""
    n_combos = math.prod(len(g.candidates) for g in groups)
    if n_combos > max_combos:
        raise ValueError(f"{n_combos} combos exceed max_combos={max_combos}")
    best, best_err = None, float("inf")
    for combo in itertools.product(*(range(len(g.candidates))
                                     for g in groups)):
        bts = sum(g.bytes_[c] for g, c in zip(groups, combo))
        if bts > budget_bytes:
            continue
        err = sum(g.errors[c] for g, c in zip(groups, combo))
        if err < best_err - 1e-12:
            best, best_err = list(combo), err
    if best is None:
        raise ValueError(f"budget {budget_bytes} B infeasible")
    return best


# ---------------------------------------------------------------------------
# Emission: the solved plan as a QuantRecipe.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Allocation:
    """A solved plan: ``recipe`` (exact-path or scan-uniform glob rules,
    ready for ``quantize_model(recipe=)``), the exact ``total_bytes`` and
    ``total_error`` of the choice, and one ``{pattern, paths, spec, bytes,
    err}`` row a site group in ``table``."""
    recipe: QuantRecipe
    budget_bytes: int
    total_bytes: int
    total_error: float
    table: list[dict]

    def summary(self) -> str:
        lines = [f"allocation: {self.total_bytes}/{self.budget_bytes} B, "
                 f"proxy error {self.total_error:.4g}"]
        for row in self.table:
            s = row["spec"]
            what = ("skip (dense)" if s.skip else
                    f"{s.method}/{s.qspec.bits}b/r{s.qspec.rank}")
            lines.append(f"  {row['pattern']:<28} {what:<16} "
                         f"{row['bytes']:>10} B  err {row['err']:.4g}")
        return "\n".join(lines)


def emit_recipe(groups: list[SiteGroup], choice: Sequence[int],
                base: QSpec, default_method: str = "cloq") -> QuantRecipe:
    """The chosen plan as ordered first-match-wins rules, each group's
    fully specified (method, bits, group_size, rank, split; ``skip`` for
    the dense choice), so it does not depend on the recipe's defaults."""
    rules = []
    for g, c in zip(groups, choice):
        spec = g.candidates[c]
        if spec.skip:
            rules.append(SiteRule(g.pattern, skip=True))
        else:
            q = spec.qspec
            rules.append(SiteRule(g.pattern, method=spec.method, bits=q.bits,
                                  group_size=q.group_size, rank=q.rank,
                                  split=q.split))
    return QuantRecipe(rules=tuple(rules), method=default_method, qspec=base)


def build_allocation(tasks: list[LayerTask],
                     path_meta: dict[str, tuple[int, int, int, int]],
                     budget_bytes: int, base: QSpec, grid=None,
                     dtype=torch.bfloat16, *,
                     scan_containers: Sequence[str] = (),
                     include_skip: bool = False, mesh=None,
                     axis: str = "model",
                     progress: Callable[[str], None] | None = None
                     ) -> Allocation:
    """Group -> sweep -> solve -> emit over gathered tasks.  The model
    entry point is :func:`repro_torch.core.pipeline.allocate_plan`."""
    grid = default_grid() if grid is None else tuple(grid)
    groups = group_sites(path_meta, scan_containers)
    groups = sweep_sensitivity(tasks, groups, grid, base, dtype,
                               include_skip=include_skip, mesh=mesh,
                               axis=axis, progress=progress)
    choice = solve_budget(groups, budget_bytes)
    recipe = emit_recipe(groups, choice, base)
    table = [{"pattern": g.pattern, "paths": list(g.paths),
              "spec": g.candidates[c], "bytes": g.bytes_[c],
              "err": g.errors[c]}
             for g, c in zip(groups, choice)]
    return Allocation(
        recipe=recipe, budget_bytes=budget_bytes,
        total_bytes=sum(r["bytes"] for r in table),
        total_error=sum(r["err"] for r in table), table=table)
