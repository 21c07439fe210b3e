"""Canonical metric names — the committed contract for dashboards.

A copy of ``repro.obs.names``: the same names and histogram edges, so a
metrics snapshot of the port reads like one of the JAX package
(``tests/test_torch_serving.py`` holds the two registries equal).  The
port emits the checkpoint, serving and training ones; the others are
declared for the subsystems still to be ported.
"""
from __future__ import annotations

# -- quantization engine ---------------------------------------------------

QUANT_BUCKETS = "quant.buckets"
QUANT_TASKS = "quant.tasks"
QUANT_PATH = "quant.path."           # + replicated|sharded|sequential
CALIB_BATCHES_USED = "calib.batches_used"
CALIB_BATCHES_SKIPPED = "calib.batches_skipped"

EXEC_PATHS = ("replicated", "sharded", "sequential")

# -- persisted compile cache -----------------------------------------------

CACHE_HITS = "compile_cache.hits"
CACHE_MISSES = "compile_cache.misses"
CACHE_CORRUPT = "compile_cache.corrupt"
CACHE_UNPORTABLE = "compile_cache.unportable"

# -- health ladder ---------------------------------------------------------

HEALTH_CHECKED = "health.checked"
HEALTH_PREFIX = "health."            # + one status per record below
HEALTH_STATUSES = ("recovered_redamp", "recovered_identity_gram",
                   "fallback_rtn", "fallback_dense",
                   "fallback_zero_adapters")

# -- quantization journal --------------------------------------------------

JOURNAL_RESTORED = "journal.restored_buckets"
JOURNAL_COMMITTED = "journal.committed_buckets"
JOURNAL_SKIPPED_TASKS = "journal.skipped_tasks"

# -- checkpointing ---------------------------------------------------------

CKPT_SAVES = "ckpt.saves"
CKPT_RESTORES = "ckpt.restores"

# -- serving ---------------------------------------------------------------

SERVE_SUBMITTED = "serve.requests_submitted"
SERVE_ADMITTED = "serve.requests_admitted"
SERVE_FINISHED = "serve.requests_finished"
SERVE_TOKENS = "serve.tokens"
SERVE_STEPS = "serve.steps"
SERVE_KV_PAGES_IN_USE = "serve.kv_pages_in_use"
SERVE_KV_PAGES_TOTAL = "serve.kv_pages_total"
SERVE_TTFT = "serve.ttft_s"
SERVE_TOKEN_LATENCY = "serve.token_latency_s"
SERVE_QUEUE_WAIT = "serve.queue_wait_s"
SERVE_KV_OCCUPANCY = "serve.kv_occupancy"

# -- training --------------------------------------------------------------

TRAIN_STEPS = "train.steps"
TRAIN_STEP_TIME = "train.step_s"

# -- declarations ----------------------------------------------------------

COUNTERS = (
    QUANT_BUCKETS, QUANT_TASKS,
    *(QUANT_PATH + p for p in EXEC_PATHS),
    CALIB_BATCHES_USED, CALIB_BATCHES_SKIPPED,
    CACHE_HITS, CACHE_MISSES, CACHE_CORRUPT, CACHE_UNPORTABLE,
    HEALTH_CHECKED,
    *(HEALTH_PREFIX + s for s in HEALTH_STATUSES),
    JOURNAL_RESTORED, JOURNAL_COMMITTED, JOURNAL_SKIPPED_TASKS,
    CKPT_SAVES, CKPT_RESTORES,
    SERVE_SUBMITTED, SERVE_ADMITTED, SERVE_FINISHED,
    SERVE_TOKENS, SERVE_STEPS,
    TRAIN_STEPS,
)

GAUGES = (
    SERVE_KV_PAGES_IN_USE,
    SERVE_KV_PAGES_TOTAL,
)

_LATENCY_EDGES = (0.0005, 0.001, 0.003, 0.01, 0.03, 0.1,
                  0.3, 1.0, 3.0, 10.0)
_FRACTION_EDGES = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

HISTOGRAMS = {
    SERVE_TTFT: _LATENCY_EDGES,
    SERVE_TOKEN_LATENCY: _LATENCY_EDGES,
    SERVE_QUEUE_WAIT: _LATENCY_EDGES,
    SERVE_KV_OCCUPANCY: _FRACTION_EDGES,
    TRAIN_STEP_TIME: _LATENCY_EDGES + (30.0, 100.0),
}


def default_edges(name: str) -> tuple[float, ...] | None:
    """Declared bucket edges for ``name``, or None when unregistered."""
    return HISTOGRAMS.get(name)


def registry_dict() -> dict:
    """The committed-contract form (mirrored in
    ``tools/obs_metric_names.json``)."""
    return {
        "counters": sorted(COUNTERS),
        "gauges": sorted(GAUGES),
        "histograms": {n: list(HISTOGRAMS[n])
                       for n in sorted(HISTOGRAMS)},
    }
