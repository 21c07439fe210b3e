"""DTYPE and PRNG rules: numeric-contract hazards.

DTYPE — float64 in device-adjacent code.  The port computes in the
model's dtype with f32 accumulation, as the JAX package does (no x64
there): a ``torch.float64`` / ``torch.double`` / ``.double()`` on a
device tensor runs at a fraction of the card's f32 rate, and makes "the
same" arithmetic differ between the packages; an ``np.float64`` pulls
host math to double precision beside it.  Outside the host-side modules
(:data:`HOST_SIDE`, e.g. ``health.py``'s deliberately-f64 guard
accounting) each is flagged.

PRNG — the port's rule is explicit generators.  ``torch.rand``/
``randn``/... , ``Tensor.normal_``/``uniform_``/``random_`` and
``nn.init.*`` without ``generator=`` draw from the global RNG, which any
library call may advance: a run is then not reproducible from its seed.
And two generators seeded with the same expression in one scope, both
feeding samplers, draw identical streams — the torch form of the JAX
package's key reuse.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astlib
from repro_torch.analysis.engine import Finding

# host-side modules where float64 math is the point (guard accounting,
# cost calibration, the compile cache's keys, fault plans, checkpoint
# CRCs, data synthesis).  Matched by suffix against the linted file's
# relative path.
HOST_SIDE = (
    "core/health.py",
    "core/costmodel.py",
    "core/compile_cache.py",
    "core/faults.py",
    "checkpoint/manager.py",
    "data/pipeline.py",
)

_F64_ATTRS = {"float64", "double", "longdouble", "float128"}
_TORCH_F64 = {"float64", "double"}
# torch samplers that take generator=
SAMPLERS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
            "multinomial", "poisson", "rand_like", "randn_like",
            "randint_like"}
# in-place Tensor samplers
INPLACE_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                    "exponential_", "cauchy_", "geometric_", "log_normal_"}


def is_host_side(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(norm.endswith(sfx) for sfx in HOST_SIDE)


def check_dtype(tree: ast.Module, source: str, path: str) -> list[Finding]:
    if is_host_side(path):
        return []
    findings: list[Finding] = []
    # fixture snippets and REPL fragments often omit the imports: fall
    # back to the conventional aliases
    nps = astlib.module_aliases(tree, "numpy") or {"np"}
    torches = astlib.module_aliases(tree, "torch") or {"torch"}
    for node in astlib.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name):
            root = node.value.id
            if root in nps and node.attr in _F64_ATTRS:
                what = f"np.{node.attr}"
            elif root in torches and node.attr in _TORCH_F64:
                what = f"torch.{node.attr}"
            else:
                continue
            findings.append(Finding(
                "DTYPE", path, node.lineno,
                f"{what} in device-adjacent code — the port computes f32 "
                "at most; this promotes the math to f64",
                hint="use float32 (or move the math to a host-side "
                     "module, HOST_SIDE)",
                context=astlib.context_name(node)))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "double" and not node.args:
            findings.append(Finding(
                "DTYPE", path, node.lineno,
                ".double() in device-adjacent code — an f64 tensor runs "
                "at a fraction of the card's f32 rate",
                hint="use .float() (or move the math to a host-side "
                     "module, HOST_SIDE)",
                context=astlib.context_name(node)))
    return findings


# --- PRNG ------------------------------------------------------------------


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords) or \
        any(kw.arg is None for kw in call.keywords)     # **kwargs


def _sampler(call: ast.Call, torches: set[str]) -> str | None:
    """The global-RNG sampler ``call`` is, when it is one."""
    name = astlib.dotted_name(call.func) or ""
    base, _, last = name.rpartition(".")
    if base in torches and last in SAMPLERS:
        return name
    if last in INPLACE_SAMPLERS and base:
        return f".{last}()"
    if base.rsplit(".", 1)[-1] == "init" and last.endswith("_"):
        return name                        # nn.init.normal_ and the rest
    return None


def _scopes(tree: ast.Module):
    yield tree
    for node in astlib.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node


def _scope_nodes(scope):
    """Walk a scope's body without descending into nested scopes."""
    stack = ([scope.body] if isinstance(scope, ast.Lambda)
             else list(scope.body))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue                       # a nested scope of its own
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _generator_seed(value: ast.AST) -> tuple[bool, ast.AST | None]:
    """``(is a generator, its seed expression)`` of an assigned value:
    ``torch.Generator(...)`` (unseeded) or ``torch.Generator(...)
    .manual_seed(s)``."""
    if isinstance(value, ast.Call) and \
            astlib.leaf(astlib.call_target(value)) == "Generator":
        return True, None
    if isinstance(value, ast.Call) and \
            isinstance(value.func, ast.Attribute) and \
            value.func.attr == "manual_seed" and value.args and \
            isinstance(value.func.value, ast.Call) and \
            astlib.leaf(astlib.call_target(value.func.value)) == "Generator":
        return True, value.args[0]
    return False, None


def _same_seed_findings(scope, path: str) -> list[Finding]:
    """Two generators of one scope seeded with the same expression, both
    passed as ``generator=`` to samplers."""
    seeds: dict[str, str] = {}            # generator name -> seed dump
    used: dict[str, ast.Call] = {}         # generator name -> first sampler
    for node in sorted(_scope_nodes(scope),
                       key=lambda n: (getattr(n, "lineno", 0),
                                      getattr(n, "col_offset", 0))):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            is_gen, seed = _generator_seed(node.value)
            if is_gen:
                name = node.targets[0].id
                seeds.pop(name, None)
                used.pop(name, None)
                if seed is not None:
                    seeds[name] = ast.dump(seed)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "manual_seed" and node.args and \
                isinstance(node.func.value, ast.Name):
            seeds[node.func.value.id] = ast.dump(node.args[0])
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "generator" and isinstance(kw.value, ast.Name):
                    used.setdefault(kw.value.id, node)
    findings = []
    by_seed: dict[str, list[str]] = {}
    for name, seed in seeds.items():
        if name in used:
            by_seed.setdefault(seed, []).append(name)
    for names in by_seed.values():
        if len(names) < 2:
            continue
        names.sort(key=lambda n: used[n].lineno)
        call = used[names[1]]
        findings.append(Finding(
            "PRNG", path, call.lineno,
            f"generators {names[0]!r} and {names[1]!r} are seeded with the "
            "same expression — identical streams feed two samplers",
            hint="seed each generator from its own expression (e.g. seed "
                 "+ a per-site offset), or share one generator",
            context=astlib.function_name(scope)
            if not isinstance(scope, ast.Module) else "<module>"))
    return findings


def check_prng(tree: ast.Module, source: str, path: str) -> list[Finding]:
    findings: list[Finding] = []
    torches = astlib.module_aliases(tree, "torch") or {"torch"}
    for node in astlib.walk(tree):
        if isinstance(node, ast.Call) and not _has_generator(node):
            what = _sampler(node, torches)
            if what:
                findings.append(Finding(
                    "PRNG", path, node.lineno,
                    f"{what} without generator= draws from the global RNG "
                    "— the run is not reproducible from its seed",
                    hint="pass generator=torch.Generator(device)."
                         "manual_seed(seed)",
                    context=astlib.context_name(node)))
    for scope in _scopes(tree):
        findings.extend(_same_seed_findings(scope, path))
    return findings
