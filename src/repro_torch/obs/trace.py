"""Zero-dependency span tracer with chrome-trace (Perfetto) export.

The port's twin of ``repro.obs.trace``, with the same public API and the
same events.  Spans are context managers (or the :func:`traced`
decorator) recording wall-clock intervals with attributes, process id and
thread id.  The module-level tracer is **disabled by default** and every
``span()`` call then returns a shared no-op singleton: one function call
plus a bool check, nothing allocated.

CUDA launches are asynchronous: a span that closes right after a kernel
launch has measured the enqueue, not the device work.  When
``REPRO_TRACE_SYNC=1`` (or ``enable(sync=True)``), the CUDA tensors
registered via ``span.sync(tree)`` are fenced at span close with
``torch.cuda.synchronize`` on their devices, *before* the end timestamp
is read, so the span brackets the device work.  No fence is taken while
the current stream is capturing a CUDA graph (a capture runs nothing,
and a synchronize would end it); CPU tensors need none.

Export is the chrome-trace JSON format (``{"traceEvents": [...]}`` with
``"X"`` complete events, microsecond timestamps): load the file at
https://ui.perfetto.dev or ``chrome://tracing``.

>>> tr = Tracer()
>>> tr.enabled = True
>>> with tr.span("bucket.execute", bucket=0) as sp:
...     sp = sp.set(path="stacked")
>>> ev = tr.events()[0]
>>> ev["name"], ev["ph"], ev["args"]
('bucket.execute', 'X', {'bucket': 0, 'path': 'stacked'})
>>> sorted(tr.to_dict())
['displayTimeUnit', 'traceEvents']
>>> tr.enabled = False
>>> tr.span("ignored") is tr.span("also-ignored")   # shared no-op
True
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

SYNC_ENV = "REPRO_TRACE_SYNC"


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, tree):
        return tree


_NULL_SPAN = _NullSpan()


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, and dicts,
    lists and tuples of them; anything else is skipped)."""
    import torch
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def fence(tree) -> None:
    """Wait for the device work behind the CUDA tensors in ``tree``: one
    ``torch.cuda.synchronize`` a device, none while a CUDA graph is being
    captured on the current stream."""
    devices = _cuda_devices(tree, set())
    if not devices:
        return
    import torch
    if torch.cuda.is_current_stream_capturing():
        return
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)


class Span:
    """One live span; record happens at ``__exit__``."""
    __slots__ = ("_tracer", "name", "args", "_t0", "_pending")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._pending = None

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (shown under *args* in Perfetto)."""
        self.args.update(attrs)
        return self

    def sync(self, tree):
        """Register ``tree`` for a device fence at close.

        A no-op passthrough unless the tracer was enabled with sync
        fencing (``REPRO_TRACE_SYNC=1``), so callers can wrap launch
        results unconditionally."""
        if self._tracer.sync_fence:
            self._pending = (tree if self._pending is None
                             else (self._pending, tree))
        return tree

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            fence(pending)
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Collects span events; thread-safe; one per process is plenty."""

    def __init__(self, *, sync_fence: bool = False):
        self.enabled = False
        self.sync_fence = sync_fence
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._origin = time.perf_counter()

    # -- recording ----------------------------------------------------

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (``ph: "i"``)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "pid": os.getpid(), "tid": threading.get_ident(),
              "ts": (time.perf_counter() - self._origin) * 1e6}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, t0: float, t1: float,
                args: dict) -> None:
        ev = {"name": name, "ph": "X",
              "pid": os.getpid(), "tid": threading.get_ident(),
              "ts": (t0 - self._origin) * 1e6,
              "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    # -- export -------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_dict(self) -> dict:
        evs = self.events()
        pids = sorted({e["pid"] for e in evs})
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "tid": 0, "args": {"name": "repro"}} for pid in pids]
        return {"traceEvents":
                meta + sorted(evs, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        """Write chrome-trace JSON to ``path`` (dirs created)."""
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def is_enabled() -> bool:
    return _TRACER.enabled


def enable(*, sync: bool | None = None) -> None:
    """Turn the module tracer on.  ``sync`` overrides the
    ``REPRO_TRACE_SYNC`` env gate for device fences."""
    if sync is None:
        sync = os.environ.get(SYNC_ENV, "") == "1"
    _TRACER.sync_fence = sync
    _TRACER.enabled = True


def disable() -> None:
    _TRACER.enabled = False


def span(name: str, **args):
    """Open a span on the module tracer (no-op singleton when off)."""
    if not _TRACER.enabled:        # fast path: no kwargs dict consumers
        return _NULL_SPAN
    return Span(_TRACER, name, args)


def instant(name: str, **args) -> None:
    _TRACER.instant(name, **args)


def export(path) -> None:
    _TRACER.export(path)


def traced(name: str | None = None, **attrs):
    """Decorator form: ``@traced("quant.calibrate")``."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with Span(_TRACER, label, dict(attrs)):
                return fn(*a, **kw)
        return wrapper
    return deco
