"""Multi-tenant CLoQ adapter serving: ONE packed quantized base, many
per-task LoRA adapters, served concurrently.  Twin of ``repro.serve``.

* :mod:`repro_torch.serve.registry` — hot-loadable per-tenant adapter
  stacks, bucketed by LoRA rank, crc32-verified load from checkpoints.
* :mod:`repro_torch.serve.scheduler` — iteration-level continuous batching
  (FIFO admission with a page barrier; starvation-free, deterministic).
* :mod:`repro_torch.serve.kv_cache` — paged KV pools with per-request page
  tables and freelist reuse.
* :mod:`repro_torch.serve.engine` — ties the three together under one
  decode step per rank bucket, captured as a CUDA graph on the card.
"""
from repro_torch.serve.engine import ServeEngine, run_workload       # noqa: F401
from repro_torch.serve.kv_cache import PageAllocator, pages_needed   # noqa: F401
from repro_torch.serve.registry import (AdapterError,                # noqa: F401
                                        AdapterRegistry,
                                        adapters_from_tree)
from repro_torch.serve.scheduler import Scheduler                    # noqa: F401
