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
    """Accumulates per-layer Gram matrices H = sum_batches X^T X (f32).

    ``keep_leading=True`` (MoE expert buffers shaped (E, C, D)) keeps the
    leading dim and accumulates one Gram per expert: H (E, D, D)."""

    def __init__(self) -> None:
        self.grams: dict[str, Tensor] = {}
        self.counts: dict[str, int] = {}

    def add(self, path: str, x: Tensor, keep_leading: bool = False) -> None:
        """H += X^T X (:func:`gram_of`)."""
        self.accumulate(path, *gram_of(x, keep_leading))

    def accumulate(self, path: str, h: Tensor, cnt: int) -> None:
        """H += h, a Gram of ``cnt`` rows."""
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


def gram_of(x: Tensor, keep_leading: bool = False) -> tuple[Tensor, int]:
    """(X^T X in f32, rows) through the ``gram`` kernel wrapper: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA one (which takes x
    in its own dtype and upcasts inside).  With ``keep_leading`` one call a
    leading slice ``x[e]`` (C, D), stacked to (E, D, D): each expert's Gram
    exactly symmetric, as a 2-D site's."""
    from repro_torch.kernels import ops
    if keep_leading:
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        return (torch.stack([ops.gram(x3[e]) for e in range(x3.shape[0])]),
                x3.shape[1])
    return ops.gram(x), math.prod(x.shape[:-1])


# a bound below f32's largest value (3.4e38): activations at most ``a``
# in size over ``T`` rows give Gram entries of at most ``T a^2``, so with
# ``T a^2`` under it no Gram of the batch can overflow
_F32_SAFE = 1e38


class ActivationLog:
    """A capture target holding each recorded activation of one
    calibration batch (references, no copies) instead of its Grams.

    :meth:`merge_into` adds the batch's Grams into a :class:`GramStore`
    path by path, each the same sum a per-batch scratch ``GramStore``
    would hold, so the batch costs one Gram at a time on top of the store
    rather than a second copy of every Gram.  :meth:`grams_finite` decides
    whether every Gram of the batch is finite: from the activations' size
    where that bounds the sums (one host sync), else by computing them."""

    def __init__(self) -> None:
        self.entries: list[tuple[str, Tensor, bool]] = []

    def add(self, path: str, x: Tensor, keep_leading: bool = False) -> None:
        self.entries.append((path, x, keep_leading))

    def poison(self) -> None:
        """NaN-fill every recorded activation (the calibration fault
        hook): every Gram of the batch is then non-finite."""
        self.entries = [(p, torch.full_like(x, float("nan")), k)
                        for p, x, k in self.entries]

    def grams(self) -> Iterator[tuple[str, Tensor, int]]:
        """(path, the batch's Gram, rows) a path, in first-record order;
        a path recorded twice sums its Grams in record order."""
        by_path: dict[str, list] = {}
        for p, x, k in self.entries:
            by_path.setdefault(p, []).append((x, k))
        for p, recs in by_path.items():
            h, cnt = gram_of(*recs[0])
            for x, k in recs[1:]:
                h2, c2 = gram_of(x, k)
                h, cnt = h + h2, cnt + c2
            yield p, h, cnt

    def grams_finite(self) -> bool:
        """Whether every Gram of the batch is finite.  A non-finite
        activation makes its Gram non-finite; finite ones at most ``a`` in
        size over at most ``T`` rows bound every entry by ``T a^2``, so
        below ``_F32_SAFE`` no Gram is computed; else each is."""
        if not self.entries:
            return True
        amax = torch.stack([x.abs().amax().float()
                            for _, x, _ in self.entries])
        rows = max(x.numel() // x.shape[-1] for _, x, _ in self.entries)
        top = float(amax.max())
        if not math.isfinite(top):
            return False
        if top * top * rows < _F32_SAFE:
            return True
        return all(bool(torch.isfinite(h).all()) for _, h, _ in self.grams())

    def merge_into(self, store: GramStore) -> None:
        for p, h, cnt in self.grams():
            store.accumulate(p, h, cnt)


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


def is_capturing() -> bool:
    """Whether a ``capture_grams`` context is open: the forward then records
    calibration Grams, and nothing in it is checkpointed (a recompute
    would record them again)."""
    return _capture_store() is not None


def record_activation(path: str, x: Tensor,
                      keep_leading: bool = False) -> None:
    store = _capture_store()
    if store is None:
        return
    store.add(path, x.detach(), keep_leading=keep_leading)


# ---------------------------------------------------------------------------
# Activation recompute (``ModelConfig.remat``).
# ---------------------------------------------------------------------------

_recompute_depth = 0


def is_recomputing() -> bool:
    """Whether the code running is a checkpointed region's recompute in the
    backward, where a forward side effect (the MoE drop log) must not be
    recorded a second time."""
    return _recompute_depth > 0


def checkpoint(fn, *args, save_ops: list | None = None):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant; tensors ``fn`` closes over
    get their gradients too).  The recompute runs the whole region (no
    early stop), so every kernel in it launches once more a backward, and
    under :func:`is_recomputing`.  ``save_ops``: ops whose outputs are kept
    instead of recomputed (selective checkpointing).  Without grad it is a
    plain call."""
    import torch.utils.checkpoint as tuc

    calls = [0]

    def run(*a):
        global _recompute_depth
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        _recompute_depth += 1
        try:
            return fn(*a)
        finally:
            _recompute_depth -= 1

    kw = {}
    if save_ops is not None:
        kw["context_fn"] = lambda: tuc.create_selective_checkpoint_contexts(
            save_ops)
    with tuc.set_checkpoint_early_stop(False):
        return tuc.checkpoint(run, *args, use_reentrant=False, **kw)


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
