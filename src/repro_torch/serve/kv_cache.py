"""Paged KV cache for the serving engine.  Twin of ``repro.serve.kv_cache``.

Two halves, split by where they run:

* :class:`PageAllocator` — pure-Python freelist bookkeeping.  Physical
  page 0 is reserved as a **scratch page**: inactive batch slots carry an
  all-zero page table, so their (masked, never-read) decode writes land on
  the scratch page instead of a tenant's cache.
* tensor ops on the pools — :func:`gather_pages` materializes each
  request's logical cache ``(L, B, T, Hkv, hd)`` from its page table, and
  :func:`scatter_token` writes the one new KV vector per request back to
  its physical page.  The pools live on the device and are written in
  place (the JAX twin returns new pools), so a decode step captured as a
  CUDA graph always sees them at the same address.

>>> al = PageAllocator(6)
>>> al.n_free                      # page 0 is reserved scratch
5
>>> al.alloc("r1", 2)
[1, 2]
>>> al.alloc("r2", 2)
[3, 4]
>>> al.can_alloc(2)
False
>>> al.free("r1")
2
>>> al.alloc("r3", 3)              # freed pages are reused, lowest-first
[1, 2, 5]
>>> al.check()
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

SCRATCH_PAGE = 0


class PageAllocator:
    """Freelist over ``n_pages`` physical KV pages (page 0 reserved).

    Deterministic: pages are handed out lowest-index-first, so a fixed
    request order yields a fixed page-table assignment."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self._free = list(range(1, n_pages))
        self._owned: dict[object, list[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_usable(self) -> int:
        """Max pages a single owner can ever hold."""
        return self.n_pages - 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, owner, n: int) -> list[int]:
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds pages")
        if n > len(self._free):
            raise ValueError(
                f"out of KV pages: want {n}, have {len(self._free)} free")
        pages = self._free[:n]
        self._free = self._free[n:]
        self._owned[owner] = pages
        return list(pages)

    def owned(self, owner) -> list[int]:
        return list(self._owned[owner])

    def free(self, owner) -> int:
        pages = self._owned.pop(owner)
        self._free.extend(pages)
        self._free.sort()
        return len(pages)

    def check(self) -> None:
        """Invariants: no page double-owned, none both free and owned,
        every page accounted for.  Raises AssertionError on violation."""
        held: list[int] = []
        for pages in self._owned.values():
            held.extend(pages)
        assert len(held) == len(set(held)), "page double-allocated"
        assert not (set(held) & set(self._free)), "page both free and owned"
        assert SCRATCH_PAGE not in held, "scratch page was allocated"
        assert len(held) + len(self._free) == self.n_pages - 1, "page leaked"


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def init_pools(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
               head_dim: int, dtype, device=None) -> tuple[Tensor, Tensor]:
    """Zeroed K/V page pools ``(L, n_pages, P, Hkv, hd)`` on ``device``."""
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def gather_pages(pool: Tensor, page_tables: Tensor) -> Tensor:
    """Per-request contiguous caches from the page pool.

    pool (L, n_pages, P, Hkv, hd); page_tables (B, maxp) int ->
    (L, B, maxp*P, Hkv, hd), a new tensor.  Stale or unwritten positions
    carry whatever the pool holds; the decode mask (``kpos <= idx``, or the
    kernel's ``lengths``) gives them exactly zero softmax weight."""
    L = pool.shape[0]
    B, maxp = page_tables.shape
    g = pool[:, page_tables.long()]            # (L, B, maxp, P, Hkv, hd)
    return g.reshape(L, B, maxp * pool.shape[2], *pool.shape[3:])


def extract_token(cache: Tensor, lengths: Tensor) -> Tensor:
    """The KV vector each request just wrote at position ``lengths``.

    cache (L, B, T, Hkv, hd); lengths (B,) -> (L, B, Hkv, hd)."""
    B = cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    return cache[:, rows, lengths.long()]


def scatter_token(pool: Tensor, new: Tensor, page_tables: Tensor,
                  lengths: Tensor) -> Tensor:
    """Write one new KV vector per request into its physical page, in place.

    pool (L, n_pages, P, Hkv, hd); new (L, B, Hkv, hd); page_tables
    (B, maxp); lengths (B,) = logical position being written.  Inactive
    slots (all-zero page table, length 0) collide on the scratch page by
    construction; it is never mapped.  Returns ``pool``."""
    P = pool.shape[2]
    lengths = lengths.long()
    logical = torch.div(lengths, P, rounding_mode="floor")
    phys = torch.gather(page_tables.long(), 1, logical[:, None])[:, 0]
    off = torch.remainder(lengths, P)
    pool[:, phys, off] = new.to(pool.dtype)      # index_put_
    return pool
