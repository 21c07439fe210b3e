"""Counters, gauges and fixed-bucket histograms with a JSON snapshot.

A copy of ``repro.obs.metrics``: typed instruments created on
first use, canonical names in :mod:`repro_torch.obs.names`, a
deterministic JSON snapshot.  The serving engine, its scheduler and the
checkpoint code count through the module registry, and the serve CLI reads
its summary from it.

Histogram buckets use *less-than-or-equal* upper edges: an observation
``x`` lands in the first bucket whose edge satisfies ``x <= edge``, and
``counts`` has one trailing overflow slot for ``x > edges[-1]``.

>>> reg = MetricsRegistry()
>>> reg.counter("quant.buckets").inc()
>>> h = reg.histogram("lat", edges=(0.1, 1.0))
>>> for x in (0.05, 0.1, 0.5, 2.0):
...     h.observe(x)
>>> h.counts                     # (<=0.1, <=1.0, overflow)
[2, 1, 1]
>>> snap = reg.snapshot()
>>> snap["counters"]["quant.buckets"]
1
>>> snap["histograms"]["lat"]["count"]
4
"""
from __future__ import annotations

import bisect
import json
import os
import threading

from repro_torch.obs import names


class Counter:
    """Monotonic event count."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written instantaneous value."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed upper-edge buckets (le semantics) plus overflow."""
    __slots__ = ("name", "edges", "counts", "count", "total")

    def __init__(self, name: str, edges):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name!r}: edges must be non-empty, "
                f"sorted, unique (got {edges!r})")
        self.name = name
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.count += 1
        self.total += x


class MetricsRegistry:
    """Name-keyed instruments; create-on-first-use; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            with self._lock:
                c = self.counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self._lock:
                g = self.gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, edges=None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            if edges is None:
                edges = names.default_edges(name)
            if edges is None:
                raise ValueError(
                    f"histogram {name!r} has no declared edges "
                    "(add it to repro_torch.obs.names.HISTOGRAMS or pass "
                    "edges=)")
            with self._lock:
                h = self.histograms.setdefault(
                    name, Histogram(name, edges))
        return h

    def snapshot(self) -> dict:
        """Plain-JSON view of every instrument (sorted keys, so two
        runs with identical event streams serialize identically)."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in
                             sorted(self.counters.items())},
                "gauges": {n: g.value for n, g in
                           sorted(self.gauges.items())},
                "histograms": {
                    n: {"edges": list(h.edges),
                        "counts": list(h.counts),
                        "count": h.count,
                        "sum": h.total}
                    for n, h in sorted(self.histograms.items())},
            }

    def save(self, path) -> None:
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset() -> None:
    """Clear the module registry (tests / fresh benchmark runs)."""
    _REGISTRY.reset()


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, edges=None) -> Histogram:
    return _REGISTRY.histogram(name, edges)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def save(path) -> None:
    _REGISTRY.save(path)
