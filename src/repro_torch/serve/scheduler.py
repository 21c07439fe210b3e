"""Iteration-level (continuous-batching) scheduler.  Twin of
``repro.serve.scheduler`` (its ``serve.admit`` instants included).

Model-free: the scheduler only knows rank **buckets** (each bucket = one
compiled decode executable with a fixed slot capacity), a shared
:class:`~repro_torch.serve.kv_cache.PageAllocator`, and request ids.  Every
decode step the engine calls :meth:`Scheduler.tick`, which admits queued
requests into free slots and returns the active ``{bucket: [(slot, rid)]}``
schedule; finished requests leave via :meth:`Scheduler.retire`.

Admission is FIFO with a **page barrier**: requests are scanned in arrival
order, a request whose bucket has no free slot is skipped (other buckets
keep admitting — per-bucket FIFO), but a request that has a slot and
cannot get its KV pages *halts admission entirely* until pages free up.
The barrier is what makes the policy starvation-free: a big request at the
head can never be overtaken indefinitely by small ones, because nothing is
admitted past it.  Pages are reserved for the request's whole lifetime at
admission, so an admitted request can never stall mid-flight on cache
space.

Everything is pure Python over ordered structures — schedules are
deterministic by construction, and ``trace`` records (step, admitted,
active) tuples so two runs can be compared exactly.

>>> from repro_torch.serve.kv_cache import PageAllocator
>>> s = Scheduler({8: 2}, PageAllocator(8))
>>> for rid in range(3):
...     s.submit(rid, bucket=8, n_pages=2)
>>> s.tick()                       # capacity 2: rid 2 waits its turn
{8: [(0, 0), (1, 1)]}
>>> s.retire(0)
>>> s.tick()                       # freed slot 0 is refilled FIFO
{8: [(0, 2), (1, 1)]}
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.kv_cache import PageAllocator


@dataclasses.dataclass
class _Pending:
    rid: object
    bucket: object
    n_pages: int


class Scheduler:
    def __init__(self, capacities: dict, allocator: PageAllocator):
        self.allocator = allocator
        self._capacity = dict(capacities)
        self._slots = {b: [None] * c for b, c in self._capacity.items()}
        self._queue: list[_Pending] = []
        self._where: dict = {}           # rid -> (bucket, slot) while active
        self._pages: dict = {}           # rid -> [page, ...]
        self.submitted: list = []
        self.retired: list = []
        self.trace: list = []
        self._step = 0

    # -- setup -------------------------------------------------------------

    def ensure_bucket(self, bucket, capacity: int) -> None:
        """Register a bucket lazily (first tenant of a new rank)."""
        if bucket not in self._capacity:
            self._capacity[bucket] = capacity
            self._slots[bucket] = [None] * capacity

    # -- request lifecycle -------------------------------------------------

    def submit(self, rid, bucket, n_pages: int) -> None:
        if bucket not in self._capacity:
            raise KeyError(f"unknown bucket {bucket!r}")
        if n_pages > self.allocator.n_usable:
            raise ValueError(
                f"request {rid!r} needs {n_pages} KV pages but the pool "
                f"only has {self.allocator.n_usable} — raise n_pages or "
                "shrink prompt+max_new")
        self._queue.append(_Pending(rid, bucket, n_pages))
        self.submitted.append(rid)

    def tick(self) -> dict:
        """Admit what fits (FIFO + page barrier), return the active map."""
        admitted = []
        still: list[_Pending] = []
        barrier = False
        for req in self._queue:
            if barrier:
                still.append(req)
                continue
            slots = self._slots[req.bucket]
            if None not in slots:
                still.append(req)        # bucket full; others may proceed
                continue
            if not self.allocator.can_alloc(req.n_pages):
                barrier = True           # head-of-line blocks all admission
                still.append(req)
                continue
            slot = slots.index(None)
            slots[slot] = req.rid
            self._pages[req.rid] = self.allocator.alloc(req.rid, req.n_pages)
            self._where[req.rid] = (req.bucket, slot)
            admitted.append(req.rid)
        self._queue = still
        if admitted:
            obs_metrics.counter(obs_names.SERVE_ADMITTED).inc(
                len(admitted))
            obs_trace.instant("serve.admit", step=self._step,
                              n=len(admitted))
        active = {b: [(s, rid) for s, rid in enumerate(slots)
                      if rid is not None]
                  for b, slots in self._slots.items()}
        self.trace.append((self._step, tuple(admitted),
                           tuple(sorted((str(b), s, rid)
                                        for b, ent in active.items()
                                        for s, rid in ent))))
        self._step += 1
        return active

    def retire(self, rid) -> None:
        bucket, slot = self._where.pop(rid)
        self._slots[bucket][slot] = None
        self.allocator.free(rid)
        self._pages.pop(rid)
        self.retired.append(rid)

    # -- views -------------------------------------------------------------

    def pages_of(self, rid) -> list[int]:
        return list(self._pages[rid])

    def slot_of(self, rid) -> tuple:
        return self._where[rid]

    def outstanding(self) -> int:
        return len(self._queue) + len(self._where)
