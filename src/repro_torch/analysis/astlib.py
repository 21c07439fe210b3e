"""Shared AST machinery for the port's reprolint rules.

Everything here is plain :mod:`ast`: nothing is imported from the linted
code, nothing runs on a device.  The generic helpers (``parse_module``,
``dotted_name``, ``call_target``, ``ancestors``, ...) are the JAX
package's; what is torch's is which calls matter.

The load-bearing abstraction is the **captured-context map**
(:func:`captured_functions`): the function/lambda nodes whose bodies run
while a CUDA graph is being captured.  A function is captured when it is

* passed by name as the first argument to a capture wrapper
  (:data:`CAPTURE_WRAPPERS`: ``CapturedStep(fn)``,
  ``torch.cuda.make_graphed_callables(fn, ...)``) anywhere in the module,
* a lambda appearing directly as that argument, or
* lexically nested inside another captured function.

The statements of a ``with torch.cuda.graph(...):`` body are captured too
(:func:`in_graph_body`).  What runs at capture runs once: a replay
re-issues the recorded device work and nothing of the host's.
"""
from __future__ import annotations

import ast

# leaves of the callables that capture their first argument as a CUDA graph
CAPTURE_WRAPPERS = {"CapturedStep", "make_graphed_callables"}
# dotted names of the graph objects and contexts (RETRACE, PURITY)
GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
GRAPH_OBJECTS = {"torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph"}
# calls that wait for the device
SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
# tensor methods that copy to the host, so wait for the device
SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}


def parse_module(source: str, path: str = "<string>") -> ast.Module:
    """Parse ``source`` and annotate every node with ``.parent``."""
    tree = ast.parse(source, filename=path)
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]
    tree.parent = None  # type: ignore[attr-defined]
    return tree


def walk(tree: ast.AST) -> list[ast.AST]:
    """``list(ast.walk(tree))`` (breadth first: a parent before its
    children), kept on a module so that every rule walks it once."""
    if not isinstance(tree, ast.Module):
        return list(ast.walk(tree))
    found = getattr(tree, "_nodes", None)
    if found is None:
        found = list(ast.walk(tree))
        tree._nodes = found  # type: ignore[attr-defined]
    return found


def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` from a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_target(call: ast.Call) -> str | None:
    """Dotted name of the called object, unwrapping ``partial(f, ...)``."""
    name = dotted_name(call.func)
    if name in ("functools.partial", "partial") and call.args:
        inner = dotted_name(call.args[0])
        return inner
    return name


def leaf(name: str | None) -> str:
    """The last part of a dotted name ("" for None)."""
    return (name or "").rsplit(".", 1)[-1]


def ancestors(node: ast.AST):
    cur = getattr(node, "parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "parent", None)


def enclosing_function(node: ast.AST):
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda, or None."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return anc
    return None


def function_name(node: ast.AST) -> str:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return node.name
    if isinstance(node, ast.Lambda):
        return "<lambda>"
    return "<module>"


def context_name(node: ast.AST) -> str:
    """Name of the function whose body contains ``node`` (for baseline
    fingerprints — stable across line-number drift)."""
    fn = enclosing_function(node)
    return function_name(fn) if fn is not None else "<module>"


def param_names(fn: ast.FunctionDef | ast.Lambda) -> list[str]:
    a = fn.args
    names = [p.arg for p in
             (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def decorator_targets(fn: ast.FunctionDef) -> set[str]:
    """Dotted names of decorators, looking through ``partial(...)``."""
    out: set[str] = set()
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            name = call_target(dec)
        else:
            name = dotted_name(dec)
        if name:
            out.add(name)
    return out


def is_capture_call(node: ast.AST) -> bool:
    """A call of a capture wrapper (``CapturedStep(fn)``, ``torch.cuda.
    make_graphed_callables(fn, args)``, under any module prefix)."""
    return isinstance(node, ast.Call) and \
        leaf(call_target(node)) in CAPTURE_WRAPPERS


def is_graph_context(node: ast.AST) -> bool:
    """A ``torch.cuda.graph(...)`` call: the context that captures."""
    return isinstance(node, ast.Call) and \
        call_target(node) in GRAPH_CONTEXTS


def captured_functions(tree: ast.Module) -> set[ast.AST]:
    """Function/Lambda nodes whose bodies run under a CUDA graph capture."""
    by_name: set[str] = set()
    marked: set[ast.AST] = set()
    for node in walk(tree):
        if is_capture_call(node) and node.args:
            first = node.args[0]
            if isinstance(first, ast.Name):
                by_name.add(first.id)
            elif isinstance(first, ast.Lambda):
                marked.add(first)
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                (node.name in by_name or
                 {leaf(d) for d in decorator_targets(node)}
                 & CAPTURE_WRAPPERS):
            marked.add(node)
    # capture is transitive: defs nested inside a marked function (one
    # breadth-first pass reaches an outer def before its inner ones)
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node not in marked and \
                enclosing_function(node) in marked:
            marked.add(node)
    return marked


def in_marked_context(node: ast.AST, marked: set[ast.AST]) -> bool:
    fn = enclosing_function(node)
    while fn is not None:
        if fn in marked:
            return True
        fn = enclosing_function(fn)
    return False


def in_graph_body(node: ast.AST) -> bool:
    """``node`` sits in the body of a ``with torch.cuda.graph(...):``
    reached before any function boundary."""
    prev = node
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False
        if isinstance(anc, (ast.With, ast.AsyncWith)) and \
                any(is_graph_context(item.context_expr)
                    for item in anc.items) and \
                any(prev is stmt for stmt in anc.body):
            return True
        prev = anc
    return False


def is_sync_call(node: ast.AST) -> bool:
    """A call that waits for the device: ``torch.cuda.synchronize()``, an
    event's or stream's ``.synchronize()``, or a tensor's ``.item()`` /
    ``.cpu()`` / ``.tolist()`` / ``.numpy()``."""
    if not isinstance(node, ast.Call):
        return False
    if call_target(node) in SYNC_CALLS:
        return True
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in SYNC_METHODS and not node.args


def subtree_mentions(node: ast.AST, roots: set[str]) -> bool:
    """True when any Name in the subtree has an id in ``roots`` (e.g. a
    ``torch``-rooted expression inside a ``np.`` call)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in roots:
            return True
    return False


def _imports(tree: ast.Module) -> list[ast.AST]:
    """The module's import statements (walked once a tree)."""
    found = getattr(tree, "_imports", None)
    if found is None:
        found = [n for n in walk(tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))]
        tree._imports = found  # type: ignore[attr-defined]
    return found


def module_aliases(tree: ast.Module, module: str) -> set[str]:
    """Local names bound to ``module`` by ``import module [as x]`` or
    ``from parent import leaf [as x]`` (``import torch.distributed`` binds
    the dotted ``torch.distributed``)."""
    out: set[str] = set()
    parent, _, last = module.rpartition(".")
    for node in _imports(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or module)
        elif parent and node.module == parent:
            for a in node.names:
                if a.name == last:
                    out.add(a.asname or last)
    return out


def imported_names(tree: ast.Module, module: str) -> dict[str, str]:
    """``{local name: imported name}`` of ``from module import a [as b]``."""
    out: dict[str, str] = {}
    for node in _imports(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out
