"""Shared utilities: device choice, name scopes, activation capture, tree
helpers.  PyTorch twin of ``repro.utils``."""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Iterator

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Device choice for entry points.
# ---------------------------------------------------------------------------


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Asking for CUDA (explicitly or by default) on a host without
    it raises; nothing continues quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Name scopes (dot paths keying calibration Grams and quantized layers).
# ---------------------------------------------------------------------------

_state = threading.local()


def _scope_stack() -> list[str]:
    if not hasattr(_state, "scopes"):
        _state.scopes = []
    return _state.scopes


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    _scope_stack().append(str(name))
    try:
        yield
    finally:
        _scope_stack().pop()


def current_scope() -> str:
    return ".".join(_scope_stack())


# ---------------------------------------------------------------------------
# Activation capture for calibration.  ``linear_apply`` calls
# ``record_activation(path, x)``; inside a ``capture_grams`` context the Gram
# matrix H += X^T X is accumulated in float32 on the activation's device.
# ---------------------------------------------------------------------------


class GramStore:
    """Accumulates per-layer Gram matrices H = sum_batches X^T X (f32)."""

    def __init__(self) -> None:
        self.grams: dict[str, Tensor] = {}
        self.counts: dict[str, int] = {}

    def add(self, path: str, x: Tensor) -> None:
        """H += X^T X through the ``gram`` kernel wrapper: the plain version
        for a CPU tensor, the CUDA kernel for a CUDA one (which takes x in
        its own dtype and upcasts inside)."""
        from repro_torch.kernels import ops
        h = ops.gram(x)
        cnt = math.prod(x.shape[:-1])
        if path in self.grams:
            self.grams[path] = self.grams[path] + h
            self.counts[path] += cnt
        else:
            self.grams[path] = h
            self.counts[path] = cnt

    def gram(self, path: str) -> Tensor:
        return self.grams[path]

    def paths(self) -> list[str]:
        return sorted(self.grams)

    def merge(self, other: "GramStore") -> None:
        """Accumulate another store's sums into this one (path-wise)."""
        for path, h in other.grams.items():
            if path in self.grams:
                self.grams[path] = self.grams[path] + h
                self.counts[path] += other.counts[path]
            else:
                self.grams[path] = h
                self.counts[path] = other.counts[path]

    def all_finite(self) -> bool:
        """True when every accumulated Gram is fully finite."""
        return all(bool(torch.isfinite(g).all()) for g in self.grams.values())


def _capture_store() -> GramStore | None:
    return getattr(_state, "capture", None)


@contextlib.contextmanager
def capture_grams(store: GramStore) -> Iterator[GramStore]:
    prev = getattr(_state, "capture", None)
    _state.capture = store
    try:
        yield store
    finally:
        _state.capture = prev


def record_activation(path: str, x: Tensor) -> None:
    store = _capture_store()
    if store is None:
        return
    store.add(path, x.detach())


# ---------------------------------------------------------------------------
# Tree helpers (nested dicts of tensors keyed by dot paths).
# ---------------------------------------------------------------------------


def tree_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict to {dot.path: leaf}."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(tree_paths(v, p))
    else:
        out[prefix] = tree
    return out


def get_path(tree: Any, path: str) -> Any:
    node = tree
    for k in path.split("."):
        node = node[k]
    return node


def set_path(tree: dict, path: str, value: Any) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def tree_size_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree_paths(tree).values() if isinstance(x, Tensor))


def tree_param_count(tree: Any) -> int:
    return sum(x.numel() for x in tree_paths(tree).values()
               if isinstance(x, Tensor))


def assert_finite(tree: Any, what: str = "tree") -> None:
    for path, leaf in tree_paths(tree).items():
        if isinstance(leaf, Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"non-finite values in {what}:{path}")
