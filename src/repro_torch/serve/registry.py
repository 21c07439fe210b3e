"""Adapter registry: many per-task CLoQ adapter pairs over ONE packed base.
Twin of ``repro.serve.registry``.

The registry owns stacked per-rank device tensors — for each LoRA rank
``r`` present, one bucket holding every site's adapters for up to
``capacity`` tenants::

    stacks(r)[site] = {"lora_a": (L, capacity, m, r),
                       "lora_b": (L, capacity, n, r)}

A bucket's stacks are allocated once, when its first tenant arrives, and
register/evict/swap write a slot of them in place: the base weights are
never touched, and a swap reaches the engine's next decode step, a
captured CUDA graph included, with no new capture.  The engine gathers
rows of the stacks by slot index inside its decode step.

Loading goes through :func:`repro_torch.checkpoint.manager.restore_tree`,
so every adapter leaf is crc32-verified on the way in; a checkpoint that
is not an adapter checkpoint for *this* model (foreign arch, stale shapes)
raises :class:`AdapterError` with one legible message.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.manager import list_steps, restore_tree
from repro_torch.utils import get_path, resolve_device, tree_paths


class AdapterError(ValueError):
    """A tenant adapter set that cannot be served over this base."""


def adapters_from_tree(params: dict) -> dict[str, dict]:
    """``{site: {"lora_a": (L, m, r), "lora_b": (L, n, r)}}`` of a
    scan-layout param tree (sites are dot-paths under ``blocks``, e.g.
    ``"attn.q"``); the leaves are the tree's own tensors or arrays."""
    blocks = params.get("blocks")
    if blocks is None:
        return {}
    out: dict[str, dict] = {}
    for path, leaf in tree_paths(blocks).items():
        if path.endswith(".lora_a") and getattr(leaf, "ndim", 0) == 3:
            site = path[: -len(".lora_a")]
            node = get_path(blocks, site)
            if "lora_b" in node:
                out[site] = {"lora_a": leaf, "lora_b": node["lora_b"]}
    return out


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def synthesize_adapters(base: dict, rank: int, seed: int,
                        scale: float = 0.02) -> dict:
    """Deterministic stand-in for a per-task fine-tuned adapter set, the
    same numbers as the JAX twin's (numpy ``default_rng(seed)``, the same
    draws in the same order): the base model's calibrated CLoQ adapters
    perturbed (same rank), or a fresh LoRA pair at another ``rank``.
    Returns float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for site in sorted(base):
        a0 = _f32(base[site]["lora_a"])
        b0 = _f32(base[site]["lora_b"])
        L, m, r0 = a0.shape
        n = b0.shape[1]
        if rank == r0:
            a = a0 + rng.normal(0, scale, a0.shape)
            b = b0 + rng.normal(0, scale, b0.shape)
        else:
            a = rng.normal(0, 1.0 / np.sqrt(m), (L, m, rank))
            b = rng.normal(0, scale, (L, n, rank))
        out[site] = {"lora_a": a.astype(np.float32),
                     "lora_b": b.astype(np.float32)}
    return out


@dataclasses.dataclass
class _RankBucket:
    rank: int
    capacity: int
    stacks: dict                      # site -> {"lora_a": ..., "lora_b": ...}
    slots: list                       # slot -> tenant name or None


class AdapterRegistry:
    """Hot-loadable per-task adapters, bucketed by LoRA rank.

    ``template``: ``{site: (L, m, n)}`` — the base model's adapter sites
    and their rank-independent shapes, used to validate every incoming
    adapter set.  The stacks live on ``device`` (CUDA unless given; the
    model's device with :meth:`from_model`) in ``dtype``."""

    def __init__(self, template: dict[str, tuple[int, int, int]], *,
                 capacity: int = 4, dtype=torch.float32,
                 device: str | torch.device | None = None):
        if not template:
            raise AdapterError("base model exposes no LoRA adapter sites")
        self.template = dict(template)
        self.capacity = capacity
        self.dtype = dtype
        self.device = resolve_device(device)
        self._buckets: dict[int, _RankBucket] = {}
        self._tenants: dict[str, tuple[int, int]] = {}   # name -> (rank, slot)

    @classmethod
    def from_model(cls, params: dict, *, capacity: int = 4,
                   dtype=torch.float32) -> "AdapterRegistry":
        sites = adapters_from_tree(params)
        template = {site: (ad["lora_a"].shape[0], ad["lora_a"].shape[1],
                           ad["lora_b"].shape[1])
                    for site, ad in sites.items()}
        device = (next(iter(sites.values()))["lora_a"].device
                  if sites else None)
        return cls(template, capacity=capacity, dtype=dtype, device=device)

    # -- validation --------------------------------------------------------

    def _validate(self, name: str, adapters: dict, origin: str = "") -> int:
        src = f" (from {origin})" if origin else ""
        if set(adapters) != set(self.template):
            raise AdapterError(
                f"adapter set {name!r}{src} does not cover this model's "
                f"sites: has {sorted(adapters)}, base expects "
                f"{sorted(self.template)} — foreign or stale checkpoint?")
        ranks = set()
        for site, (L, m, n) in self.template.items():
            a, b = adapters[site]["lora_a"], adapters[site]["lora_b"]
            if a.ndim != 3 or b.ndim != 3 or tuple(a.shape[:2]) != (L, m) \
                    or tuple(b.shape[:2]) != (L, n) or a.shape[2] != b.shape[2]:
                raise AdapterError(
                    f"adapter set {name!r}{src} site {site!r}: lora_a "
                    f"{tuple(a.shape)} / lora_b {tuple(b.shape)} do not "
                    f"match base site (layers={L}, in={m}, out={n}) — "
                    "foreign or stale checkpoint?")
            ranks.add(int(a.shape[2]))
        if len(ranks) != 1:
            raise AdapterError(
                f"adapter set {name!r}{src} mixes ranks {sorted(ranks)}; "
                "one tenant = one rank bucket")
        return ranks.pop()

    # -- lifecycle ---------------------------------------------------------

    def _bucket(self, rank: int) -> _RankBucket:
        if rank not in self._buckets:
            stacks = {}
            for site, (L, m, n) in self.template.items():
                stacks[site] = {
                    "lora_a": torch.zeros((L, self.capacity, m, rank),
                                          dtype=self.dtype,
                                          device=self.device),
                    "lora_b": torch.zeros((L, self.capacity, n, rank),
                                          dtype=self.dtype,
                                          device=self.device)}
            self._buckets[rank] = _RankBucket(rank, self.capacity, stacks,
                                              [None] * self.capacity)
        return self._buckets[rank]

    def _write_slot(self, bucket: _RankBucket, slot: int,
                    adapters: dict | None) -> None:
        """Write (or zero) one slot of every stack, in place."""
        for site in self.template:
            for leaf in ("lora_a", "lora_b"):
                st = bucket.stacks[site][leaf][:, slot]
                if adapters is None:
                    st.zero_()
                else:
                    st.copy_(torch.as_tensor(adapters[site][leaf]))

    def register(self, name: str, adapters: dict, origin: str = "") -> int:
        """Add a tenant; returns its slot within its rank bucket."""
        if name in self._tenants:
            raise AdapterError(f"tenant {name!r} already registered "
                               "(use swap() or evict() first)")
        rank = self._validate(name, adapters, origin)
        bucket = self._bucket(rank)
        if None not in bucket.slots:
            raise AdapterError(
                f"rank-{rank} bucket is full ({bucket.capacity} tenants); "
                "evict one first")
        slot = bucket.slots.index(None)
        self._write_slot(bucket, slot, adapters)
        bucket.slots[slot] = name
        self._tenants[name] = (rank, slot)
        return slot

    def load(self, name: str, directory: str, step: int | None = None) -> int:
        """Register a tenant from a checkpoint (crc32-verified restore)."""
        if not list_steps(directory):
            raise AdapterError(
                f"no complete checkpoint steps under {directory} — "
                "nothing to load an adapter set from")
        tree, _meta = restore_tree(directory, step)
        sub = tree if "blocks" in tree else tree.get("train", tree)
        adapters = adapters_from_tree(sub if isinstance(sub, dict) else {})
        if not adapters:
            raise AdapterError(
                f"checkpoint {directory} carries no stacked LoRA adapter "
                "leaves (blocks.*.lora_a/lora_b) — not an adapter "
                "checkpoint for this model")
        return self.register(name, adapters, origin=directory)

    def swap(self, name: str, adapters: dict, origin: str = "") -> int:
        """Replace a tenant's adapters in place.  Same rank keeps the slot
        (in-flight requests of OTHER tenants are untouched; this tenant's
        next decode step sees the new weights).  A rank change re-buckets
        via evict+register, which requires the tenant to have no in-flight
        requests."""
        if name not in self._tenants:
            raise AdapterError(f"tenant {name!r} is not registered")
        rank = self._validate(name, adapters, origin)
        old_rank, slot = self._tenants[name]
        if rank == old_rank:
            self._write_slot(self._buckets[rank], slot, adapters)
            return slot
        self.evict(name)
        return self.register(name, adapters, origin)

    def evict(self, name: str) -> None:
        rank, slot = self._tenants.pop(name)
        bucket = self._buckets[rank]
        self._write_slot(bucket, slot, None)     # zero: stale weights die
        bucket.slots[slot] = None

    # -- views -------------------------------------------------------------

    def slot_of(self, name: str) -> tuple[int, int]:
        """(rank, slot) for a tenant."""
        if name not in self._tenants:
            raise AdapterError(f"tenant {name!r} is not registered")
        return self._tenants[name]

    def stacks(self, rank: int) -> dict:
        return self._buckets[rank].stacks

    def ranks(self) -> list[int]:
        return sorted(self._buckets)

    def tenants(self) -> dict[str, tuple[int, int]]:
        return dict(self._tenants)

    def sites(self) -> list[str]:
        return sorted(self.template)
