"""RETRACE and PURITY rules: hazards of CUDA graph capture.

A :class:`~repro_torch.launch.steps.CapturedStep` (or a ``with
torch.cuda.graph(g):`` body) records the device work of one call; every
later call replays the recording.  The host side of the captured code
runs once, at capture.

RETRACE — a graph built inside a ``for``/``while`` body: a
``CapturedStep(...)``, ``torch.cuda.CUDAGraph()`` or ``torch.cuda.graph(
...)`` there records a new graph (and its private memory pool) every
iteration, so nothing is ever replayed — the port's form of jit-in-loop.
Build it once outside the loop, or memoize it by key.

PURITY — host effects inside captured code (a function passed to a
capture wrapper, its nested defs, or a ``torch.cuda.graph`` body):

* ``print`` runs at capture only, never on a replay;
* ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` and
  ``torch.cuda.synchronize()`` wait for the device, which a capturing
  stream refuses ("operation not permitted when stream is capturing");
* ``bool()`` / ``float()`` / ``int()`` on a tensor, and an ``if`` /
  ``while`` on one (a parameter of the captured function or a ``torch.``
  call), read a device value to the host, and bake one branch into the
  graph at best.

Shape, dtype, ``is None``, ``isinstance`` and ``len`` tests are exempt:
they are host values.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astlib
from repro_torch.analysis.engine import Finding

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "layout"}
_STATIC_METHODS = {"dim", "size", "numel", "element_size", "is_contiguous",
                   "is_floating_point", "get_device"}
_STATIC_CALLS = {"isinstance", "len", "hasattr", "getattr", "callable",
                 "type", "issubclass"}
# torch calls that return host values (``torch.cuda.*`` all do)
_TORCH_HOST = {"torch.is_tensor", "torch.is_grad_enabled",
               "torch.is_floating_point"}


def _loop_before_function(node: ast.AST) -> ast.AST | None:
    """Nearest For/While ancestor reached before any function boundary."""
    for anc in astlib.ancestors(node):
        if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
            return anc
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return None
    return None


def _builds_graph(node: ast.Call) -> str | None:
    if astlib.is_capture_call(node):
        return astlib.leaf(astlib.call_target(node))
    name = astlib.call_target(node)
    if name in astlib.GRAPH_OBJECTS or name in astlib.GRAPH_CONTEXTS:
        return name
    return None


def check_retrace(tree: ast.Module, source: str,
                  path: str) -> list[Finding]:
    findings: list[Finding] = []
    for node in astlib.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _builds_graph(node)
        if what and _loop_before_function(node) is not None:
            findings.append(Finding(
                "RETRACE", path, node.lineno,
                f"{what} built inside a loop — a new capture (and memory "
                "pool) every iteration, never a replay",
                hint="build the graph once outside the loop, or memoize "
                     "it by key",
                context=astlib.context_name(node)))
    return findings


def _static_use(name_node: ast.Name, stop: ast.AST) -> bool:
    """A Name whose use in a test is a host value: shape/dtype/... access,
    a size method, ``is (not) None``, or isinstance/len."""
    parent = getattr(name_node, "parent", None)
    if isinstance(parent, ast.Attribute):
        if parent.attr in _STATIC_ATTRS:
            return True
        call = getattr(parent, "parent", None)
        if isinstance(call, ast.Call) and call.func is parent and \
                parent.attr in _STATIC_METHODS:
            return True
    if isinstance(parent, ast.Call) and \
            astlib.call_target(parent) in _STATIC_CALLS:
        return True
    for anc in astlib.ancestors(name_node):
        if isinstance(anc, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in anc.ops):
            return True
        if anc is stop:
            break
    return False


def _torch_valued(test: ast.AST) -> bool:
    """A ``torch.`` call in ``test`` that returns a tensor (neither
    ``torch.cuda.*`` nor :data:`_TORCH_HOST`)."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            name = astlib.call_target(sub) or ""
            if name.startswith("torch.") and name not in _TORCH_HOST and \
                    not name.startswith("torch.cuda."):
                return True
    return False


def _tensor_test(test: ast.AST, params: set[str]) -> str | None:
    """What makes ``test`` a tensor expression, or None."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name) and sub.id in params and \
                isinstance(sub.ctx, ast.Load) and \
                not _static_use(sub, test):
            return f"parameter {sub.id!r}"
    if _torch_valued(test):
        return "a torch expression"
    return None


def _static_subexpr(node: ast.AST) -> bool:
    """Arg expressions that are host values: shape/dtype reads, len()."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if isinstance(sub, ast.Call) and (
                astlib.call_target(sub) in _STATIC_CALLS or
                (isinstance(sub.func, ast.Attribute) and
                 sub.func.attr in _STATIC_METHODS)):
            return True
    return False


def _captured(node: ast.AST, marked: set[ast.AST]) -> bool:
    return astlib.in_marked_context(node, marked) or \
        astlib.in_graph_body(node)


def check_purity(tree: ast.Module, source: str,
                 path: str) -> list[Finding]:
    findings: list[Finding] = []
    marked = astlib.captured_functions(tree)
    for node in astlib.walk(tree):
        if isinstance(node, (ast.If, ast.While)) and \
                _captured(node, marked):
            fn = astlib.enclosing_function(node)
            params = set(astlib.param_names(fn)) if fn is not None else set()
            why = _tensor_test(node.test, params)
            if why:
                findings.append(Finding(
                    "PURITY", path, node.lineno,
                    f"Python `{type(node).__name__.lower()}` on {why} "
                    "inside captured code reads the device at capture and "
                    "bakes one branch into the graph",
                    hint="use torch.where, or decide outside the captured "
                         "step",
                    context=astlib.context_name(node)))
            continue
        if not isinstance(node, ast.Call) or not _captured(node, marked):
            continue
        ctx = astlib.context_name(node)
        name = astlib.call_target(node)
        if name == "print":
            findings.append(Finding(
                "PURITY", path, node.lineno,
                "print() inside captured code runs at capture only, never "
                "on a replay",
                hint="return the value and print it outside the step",
                context=ctx))
        elif astlib.is_sync_call(node):
            what = (name if name in astlib.SYNC_CALLS
                    else f".{node.func.attr}()")
            findings.append(Finding(
                "PURITY", path, node.lineno,
                f"{what} inside captured code waits for the device, which "
                "a capturing stream refuses",
                hint="return the tensor and read it after the replay",
                context=ctx))
        elif name in ("bool", "float", "int") and node.args and \
                not isinstance(node.args[0], ast.Constant) and \
                not _static_subexpr(node.args[0]):
            findings.append(Finding(
                "PURITY", path, node.lineno,
                f"{name}() inside captured code reads a tensor to the "
                "host (a sync the capture refuses)",
                hint="keep it a tensor, or compute it outside the captured "
                     "step",
                context=ctx))
    return findings
