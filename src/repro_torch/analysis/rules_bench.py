"""BENCH rule: wall-clock deltas around un-synced device dispatch.

A CUDA launch returns the moment the work is queued, so

    t0 = time.perf_counter()
    out = step(x)                    # step = CapturedStep(...)
    dt = time.perf_counter() - t0    # measures the launch, not the work

silently times the host's side of the dispatch.  Every such timing must
reach a sync — ``torch.cuda.synchronize()``, an event's or stream's
``.synchronize()``, or a ``.item()``/``.cpu()``/``.tolist()``/
``.numpy()`` that waits for the result — before the stop timestamp is
read.  A module function whose body syncs (``_sync(device)``) counts as
a sync where it is called.  CUDA-event timing (``Event.record`` ...
``elapsed_time`` after a ``synchronize``) is no wall-clock delta and is
clean.

Detection is scope-local and line-ordered, as the JAX package's rule:
within one function (or the module body), an assignment ``t =
time.time()|perf_counter()|monotonic()`` followed by a ``<time call or
timer name> - t`` subtraction delimits a timed region; the region is
flagged when it holds a device dispatch and no sync.  A device dispatch
is a call of

* a :class:`~repro_torch.launch.steps.CapturedStep` (a name bound to
  ``CapturedStep(...)``, or ``CapturedStep(f)(...)`` inline), or a
  graph's ``.replay()``;
* a kernel wrapper of ``repro_torch.kernels.ops`` (``ops.gram(...)``,
  or the name imported from it; its counters are host calls);
* a step made by ``launch.steps.make_*_step`` (a name bound to its
  result).
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astlib
from repro_torch.analysis.engine import Finding

# timer sources whose subtraction delimits a timed region
_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "perf_counter", "monotonic"}
OPS_MODULE = "repro_torch.kernels.ops"
OPS_KERNELS = {"dequant_matmul", "dequant_matmul_lora", "flash_attention",
               "gram"}


def _is_time_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and astlib.call_target(node) in _TIME_CALLS)


def _makes_step(call: ast.Call) -> bool:
    name = astlib.leaf(astlib.call_target(call))
    return astlib.is_capture_call(call) or \
        (name.startswith("make_") and name.endswith("_step"))


def _dispatch_names(tree: ast.Module) -> set[str]:
    """Dotted names whose call dispatches device work: bound to a
    ``CapturedStep(...)`` or a ``make_*_step(...)``, or imported from
    ``repro_torch.kernels.ops``."""
    names = {local for local, name in
             astlib.imported_names(tree, OPS_MODULE).items()
             if name in OPS_KERNELS}
    for node in astlib.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _makes_step(node.value):
            for tgt in node.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, (ast.Name, ast.Attribute)):
                        name = astlib.dotted_name(sub)
                        if name:
                            names.add(name)
    return names


def _sync_helpers(tree: ast.Module) -> set[str]:
    """Module functions whose own body syncs (to a fixpoint: a helper that
    calls a helper)."""
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    helpers: set[str] = set()
    changed = True
    while changed:
        changed = False
        for fn in defs:
            if fn.name in helpers:
                continue
            if any(astlib.is_sync_call(n) or
                   (isinstance(n, ast.Call) and
                    astlib.call_target(n) in helpers)
                   for n in ast.walk(fn)):
                helpers.add(fn.name)
                changed = True
    return helpers


def _scopes(tree: ast.Module):
    """Yield (scope node, [nodes directly in scope]) — nested function
    bodies belong to their own scope, not the enclosing one."""
    owned: dict[ast.AST, list[ast.AST]] = {tree: []}
    for node in astlib.walk(tree):
        if node is tree:
            continue
        owner = astlib.enclosing_function(node)
        while owner is not None and not isinstance(
                owner, (ast.FunctionDef, ast.AsyncFunctionDef)):
            owner = astlib.enclosing_function(owner)
        owned.setdefault(tree if owner is None else owner, []).append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            owned.setdefault(node, [])
    yield from owned.items()


def _is_dispatch(node: ast.Call, names: set[str], ops: set[str]) -> bool:
    target = astlib.dotted_name(node.func)
    if target in names:
        return True
    base, _, leaf = (target or "").rpartition(".")
    if base in ops and leaf in OPS_KERNELS:
        return True
    if isinstance(node.func, ast.Call) and \
            astlib.is_capture_call(node.func):
        return True                        # CapturedStep(f)(x)
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr == "replay" and not node.args


def check_bench(tree: ast.Module, source: str,
                path: str) -> list[Finding]:
    names = _dispatch_names(tree)
    ops = astlib.module_aliases(tree, OPS_MODULE) | {OPS_MODULE}
    helpers = _sync_helpers(tree)
    findings: list[Finding] = []
    for scope, nodes in _scopes(tree):
        starts: list[tuple[int, str]] = []      # (line, timer name)
        dispatch_lines: list[int] = []
        sync_lines: list[int] = []
        deltas: list[tuple[int, str]] = []      # (line, rhs timer name)
        for node in nodes:
            if isinstance(node, ast.Assign) and _is_time_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        starts.append((node.lineno, tgt.id))
            elif isinstance(node, ast.Call):
                if astlib.is_sync_call(node) or \
                        astlib.call_target(node) in helpers:
                    sync_lines.append(node.lineno)
                elif _is_dispatch(node, names, ops):
                    dispatch_lines.append(node.lineno)
            elif (isinstance(node, ast.BinOp)
                  and isinstance(node.op, ast.Sub)
                  and isinstance(node.right, ast.Name)):
                lhs_ok = (_is_time_call(node.left)
                          or isinstance(node.left, ast.Name))
                if lhs_ok:
                    deltas.append((node.lineno, node.right.id))
        timer_names = {n for _, n in starts}
        for stop_line, rhs in deltas:
            if rhs not in timer_names:
                continue
            opens = [ln for ln, n in starts
                     if n == rhs and ln < stop_line]
            if not opens:
                continue
            start_line = max(opens)
            timed = [ln for ln in dispatch_lines
                     if start_line < ln < stop_line]
            if not timed:
                continue
            if any(start_line < ln < stop_line for ln in sync_lines):
                continue
            findings.append(Finding(
                "BENCH", path, stop_line,
                f"wall-clock delta over device dispatch at line "
                f"{timed[0]} with no sync — measures the launch, not the "
                "work",
                hint="torch.cuda.synchronize() before reading the stop "
                     "timestamp, or time with CUDA events",
                context=astlib.function_name(scope)))
    return findings
