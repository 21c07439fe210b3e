"""repro_torch.obs: tracing, metrics and structured logging, the port's
twin of ``repro.obs`` (the same names, events and lines).

* :mod:`repro_torch.obs.trace`: context-manager/decorator spans exported
  as chrome-trace JSON (open at https://ui.perfetto.dev); disabled by
  default, in which case every ``span()`` returns a shared no-op; under
  ``REPRO_TRACE_SYNC=1`` a span's registered CUDA tensors are fenced
  with ``torch.cuda.synchronize`` before it closes.
* :mod:`repro_torch.obs.metrics`: counters, gauges and fixed-bucket
  histograms with a deterministic JSON snapshot, under the names of
  :mod:`repro_torch.obs.names`.
* :mod:`repro_torch.obs.log`: ``[event] key=value`` structured progress
  lines with a swappable sink.

Launchers wire the lot through :func:`session`:

>>> from repro_torch import obs
>>> with obs.session():                    # no outputs requested
...     with obs.trace.span("noop"):       # no-op: tracer stays off
...         obs.metrics.counter("quant.buckets").inc()
>>> obs.metrics.counter("quant.buckets").value >= 1
True
"""
from __future__ import annotations

import contextlib

from repro_torch.obs import log, metrics, names, trace  # noqa: F401


def default_metrics_path(tool: str) -> str:
    """Where a launcher drops its snapshot when only ``--trace-out``
    was given (the ``results/metrics-*.json`` convention)."""
    return f"results/metrics-{tool}.json"


@contextlib.contextmanager
def session(trace_out=None, metrics_out=None, *, sync=None):
    """Enable tracing when ``trace_out`` is set, and on exit (even an
    exceptional one) export the trace and/or metrics snapshot."""
    if trace_out:
        trace.enable(sync=sync)
    try:
        yield
    finally:
        if trace_out:
            trace.export(trace_out)
            trace.disable()
        if metrics_out:
            metrics.save(metrics_out)
