"""Metrics for the port: counters, gauges and fixed-bucket histograms
(:mod:`repro_torch.obs.metrics`) under the JAX package's canonical names
(:mod:`repro_torch.obs.names`).  Span tracing and structured logging
(``repro.obs.trace``/``log``) are not ported yet (``ROADMAP.md``)."""
from repro_torch.obs import metrics, names  # noqa: F401
