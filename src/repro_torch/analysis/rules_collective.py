"""COLLECTIVE rule: every collective goes through the counted wrappers.

Two structural invariants the port's sharded paths depend on:

* **counted collectives** — ``models/parallel.py``'s wrappers
  (``all_reduce_sum``, ``gather_from``, ``reduce_scatter``, ...) count
  every collective they issue (``parallel.collective_stats()``), and
  ``chip_smoke.py`` holds those counts against the layout table's
  prediction.  A ``torch.distributed`` collective called anywhere else
  moves data the prediction never sees.  The deliberate uncounted ones
  (the cost model's calibration probes, a mesh barrier) take a pragma
  with their reason on the line.
* **replicated paths stay collective-free** — code guarded by
  ``exec_path == "replicated"`` (the planner's single-device fallback)
  must not reach a collective, counted or not: there is no group to
  serve it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astlib
from repro_torch.analysis.engine import Finding

# torch.distributed's collectives (and point-to-point calls)
COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_gather_coalesced", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "barrier", "monitored_barrier", "reduce",
    "gather", "gather_object", "scatter", "scatter_object_list"}
# models/parallel.py's counted wrappers: collectives all the same on the
# replicated path
COUNTED = {"all_reduce_sum", "combine_softmax", "copy_to", "reduce_from",
           "gather_from", "scatter_to", "reduce_scatter", "finish_row",
           "gather_tree", "full_tensor"}
# the one module allowed to call torch.distributed's collectives
WRAPPER_MODULE = "models/parallel.py"


def _dist_roots(tree: ast.Module) -> set[str]:
    """Names bound to ``torch.distributed`` (the conventional ``dist`` and
    ``torch.distributed`` when the snippet has no import)."""
    return (astlib.module_aliases(tree, "torch.distributed") or {"dist"}) \
        | {"torch.distributed"}


def _collective(call: ast.Call, roots: set[str],
                bare: dict[str, str]) -> str | None:
    """The torch.distributed collective ``call`` makes, or None."""
    name = astlib.dotted_name(call.func)
    if not name:
        return None
    base, _, last = name.rpartition(".")
    if base in roots and last in COLLECTIVES:
        return last
    if not base and bare.get(name) in COLLECTIVES:
        return bare[name]
    return None


def _replicated_branch(node: ast.AST) -> bool:
    """True when an ancestor If compares against the literal "replicated"
    and ``node`` sits in the branch where the comparison holds."""
    prev = node
    for anc in astlib.ancestors(node):
        if isinstance(anc, ast.If):
            eq = _compares_replicated(anc.test, ast.Eq)
            ne = _compares_replicated(anc.test, ast.NotEq)
            in_body = any(prev is n or _contains(n, prev)
                          for n in anc.body)
            if (eq and in_body) or (ne and not in_body):
                return True
        prev = anc
    return False


def _contains(tree: ast.AST, node: ast.AST) -> bool:
    return any(sub is node for sub in ast.walk(tree))


def _compares_replicated(test: ast.AST, op_type) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare) and \
                any(isinstance(op, op_type) for op in sub.ops):
            operands = [sub.left, *sub.comparators]
            if any(isinstance(o, ast.Constant) and o.value == "replicated"
                   for o in operands):
                return True
    return False


def is_wrapper_module(path: str) -> bool:
    return path.replace("\\", "/").endswith(WRAPPER_MODULE)


def check_collective(tree: ast.Module, source: str,
                     path: str) -> list[Finding]:
    findings: list[Finding] = []
    roots = _dist_roots(tree)
    bare = astlib.imported_names(tree, "torch.distributed")
    wrapper_module = is_wrapper_module(path)
    for node in astlib.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        ctx = astlib.context_name(node)
        coll = _collective(node, roots, bare)
        if coll and not wrapper_module:
            findings.append(Finding(
                "COLLECTIVE", path, node.lineno,
                f"torch.distributed.{coll} outside models/parallel.py — "
                "an uncounted collective the predicted counts never see",
                hint="call models.parallel's counted wrapper, or give a "
                     "deliberate one a pragma with its reason",
                context=ctx))
        counted = astlib.leaf(astlib.call_target(node)) in COUNTED
        if (coll or counted) and _replicated_branch(node):
            findings.append(Finding(
                "COLLECTIVE", path, node.lineno,
                f"{coll or astlib.leaf(astlib.call_target(node))} "
                "reachable on the exec_path == \"replicated\" branch — "
                "no group exists there",
                hint="replicated fallbacks must be collective-free; gate "
                     "the collective on the sharded path",
                context=ctx))
    return findings
