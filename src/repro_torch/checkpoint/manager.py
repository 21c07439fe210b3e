"""Checkpoints: atomic, checksummed, retained, optionally written in the
background.  Twin of ``repro.checkpoint.manager``, with the same format on
disk, so a checkpoint written by either package restores in the other bit
for bit:

* ``<dir>/step_XXXXXXXX/arrays.npz`` holds every leaf keyed by its dot
  path, in its own dtype; a bf16 leaf is stored as its uint16 bits under
  the key ``<path>__bf16__``;
* ``<dir>/step_XXXXXXXX/meta.json`` holds the step, the save time, the
  caller's extra metadata (the train CLI puts the data stream's state
  there) and a crc32 of each stored array; it is written last and fsynced,
  so a step directory with a ``meta.json`` is complete;
* a step is written under ``<dir>/tmp/`` and renamed into place in one
  step; an older step of the same number is moved aside first;
* :class:`CheckpointManager` keeps the newest ``keep`` steps and every
  step that carries the :data:`PIN_MARKER` file (the preemption save).

Leaves may be torch tensors on any device or numpy arrays; they are
restored as CPU torch tensors, bf16 as ``torch.bfloat16``.
:class:`QuantJournal` commits each finished bucket of the batched
quantization engine as one step, so a stopped run resumes where it stood.
A quantized checkpoint saved with ``save_tree(..., manifest=)`` (the plan
of ``repro_torch.core.pipeline.quantization_manifest``, its recipe
included) carries it in ``meta.json`` under :data:`MANIFEST_KEY`, as the
JAX package's does.  :func:`manifest_shardings` rebuilds the layout of
such a checkpoint for another mesh from that manifest alone (no planner,
no model config), and ``restore_tree(mesh=)`` gives each rank its blocks
as DTensors.  A tree holding DTensors (the sharded engine's output) is
gathered whole under the ``ckpt.gather`` span, a collective of every rank
of its mesh, and written by rank 0 alone.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.models import parallel
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import set_path, tree_paths

_BF16_TAG = "__bf16__"

# meta.json key holding the serialized bucket manifest (plan output)
MANIFEST_KEY = "bucket_manifest"

# in-progress and superseded step directories live under <dir>/tmp/
_TMP_SUBDIR = "tmp"

# marker file: a pinned step (e.g. the preemption checkpoint) that the
# retention GC never collects
PIN_MARKER = "PINNED"


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # an ml_dtypes array
        return arr.view(np.uint16)
    return arr


def _is_bf16(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.bfloat16
    return np.asarray(leaf).dtype.name == "bfloat16"


def _to_host(tree) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in tree_paths(tree).items():
        out[path + _BF16_TAG if _is_bf16(leaf) else path] = _host(leaf)
    return out


def _crc(arr: np.ndarray) -> int:
    return int(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


def _leaf_checksums(host: dict[str, np.ndarray]) -> dict[str, int]:
    """crc32 of each stored array's bytes, verified by :func:`restore_tree`
    so a flipped or truncated leaf fails, naming the leaf."""
    return {k: _crc(v) for k, v in host.items()}


def save_tree(tree, directory: str, step: int, extra_meta: dict | None = None,
              background: bool = False, manifest: dict | None = None,
              pin: bool = False) -> threading.Thread | None:
    """Write a snapshot of ``tree`` as step ``step`` of ``directory``.
    Returns the writer thread if ``background`` (the copy to the host
    happens before this returns either way).

    Everything lands in ``<dir>/tmp/`` first (arrays, then ``meta.json``,
    fsynced) and the finished directory is renamed into place; a step of
    the same number is moved aside into ``tmp/`` first and deleted after,
    so a reader never sees a half-written or half-deleted step.
    ``manifest`` (a bucket manifest, ``pipeline.quantization_manifest``)
    is stored in ``meta.json`` under :data:`MANIFEST_KEY`.  ``pin`` puts a
    :data:`PIN_MARKER` file in the step so that
    :class:`CheckpointManager`'s retention never collects it.

    A tree holding DTensors is gathered first (every rank of their mesh
    must call this); then rank 0 writes and the other ranks return None."""
    import torch.distributed as dist
    sharded = parallel.tree_has_sharded(tree)
    writer = not sharded or dist.get_rank() == 0
    if writer:
        os.makedirs(directory, exist_ok=True)
        obs_metrics.counter(obs_names.CKPT_SAVES).inc()
    with obs_trace.span("ckpt.gather", step=int(step)):
        if sharded:
            tree = parallel.gather_tree(tree)
        if not writer:
            return None
        host = _to_host(tree)          # device -> host copy: a sync point
    meta = {"step": int(step), "time": time.time()}
    meta.update(extra_meta or {})
    meta["checksums"] = _leaf_checksums(host)
    if manifest is not None:
        meta[MANIFEST_KEY] = manifest

    def write():
        from repro_torch.core import faults
        tmproot = os.path.join(directory, _TMP_SUBDIR)
        os.makedirs(tmproot, exist_ok=True)
        tag = f"{step}.{os.getpid()}.{threading.get_native_id()}"
        tmp = os.path.join(tmproot, f"new.{tag}")
        final = os.path.join(directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        if pin:
            with open(os.path.join(tmp, PIN_MARKER), "w"):
                pass
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            stale = os.path.join(tmproot, f"stale.{tag}")
            os.rename(final, stale)
            os.rename(tmp, final)
            shutil.rmtree(stale, ignore_errors=True)
        else:
            os.rename(tmp, final)
        faults.post_commit(final, step)        # shard_truncate injection

    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    with obs_trace.span("ckpt.write", step=int(step)):
        write()
    return None


def list_steps(directory: str) -> list[int]:
    """Complete checkpoint steps under ``directory``, sorted (a step
    directory without ``meta.json`` is ignored; writes in progress live in
    ``tmp/``)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.isfile(
                os.path.join(directory, name, "meta.json")):
            steps.append(int(name[len("step_"):]))
    return sorted(steps)


def _tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def manifest_shardings(manifest: dict, mesh, axis: str | None = None,
                       cost_model=None) -> dict:
    """Per-leaf layouts (:class:`repro_torch.launch.shardings.
    NamedSharding`) of a quantized checkpoint on a **new** mesh, rebuilt
    from its bucket manifest alone: no planner, no model config.

    Shard counts are re-resolved against ``mesh``: through
    ``cost_model.decide_geometry`` (the planner's rule,
    :class:`repro_torch.core.costmodel.CostModel`) when given, else the
    divisibility gate (``batched.bucket_shards``); the saved
    ``n_shards``/``exec_path`` belong to the save-time mesh.  When the
    choice differs from the saved one, ONE ``RuntimeWarning`` names the
    buckets.  Covers the weight-shared block's per-site adapter stacks and
    each task path's scan-stacked alias.  Returns ``{dot.path.leaf:
    NamedSharding}``; entries of leaves absent from a tree are ignored by
    :func:`restore_tree`."""
    from repro_torch.core.batched import (bucket_axis_size, bucket_shards,
                                          task_leaf_specs)
    from repro_torch.launch.shardings import NamedSharding

    axis = axis or manifest.get("axis", "model")
    stacked = set(manifest.get("stacked", ()))
    out: dict = {}
    diverged: list[str] = []
    for sl in manifest.get("site_lora", ()):
        k = bucket_shards(sl["n"], sl["method"], mesh, axis)
        specs = task_leaf_specs(sl["method"], axis if k > 1 else None,
                                lead=1)
        for leaf in ("lora_a", "lora_b"):
            out[f"shared.site_lora.{sl['name']}.{leaf}"] = \
                NamedSharding(mesh, specs[leaf])
    for bucket in manifest["buckets"]:
        spec = bucket["spec"]
        if cost_model is not None:
            path, k = cost_model.decide_geometry(
                spec["method"], m=spec["m"], n=spec["n"],
                L=max(len(bucket.get("tasks", ())), 1),
                k=bucket_axis_size(mesh, axis), rank=spec.get("rank", 16),
                has_gram=spec.get("has_gram"))
        else:
            k = bucket_shards(spec["n"], spec["method"], mesh, axis)
            path = "sharded" if k > 1 else "replicated"
        saved_k = int(spec.get("n_shards", 1))
        saved_path = spec.get("exec_path",
                              "sharded" if saved_k > 1 else "replicated")
        if (k, path) != (saved_k, saved_path):
            diverged.append(
                f"{spec['method']}/{spec['bits']}b {spec['m']}x{spec['n']}: "
                f"saved {saved_path} x{saved_k} -> restored {path} x{k}")
        ax = axis if k > 1 else None
        for task in bucket["tasks"]:
            lead = 0 if task["expert"] is None else 1
            # the eager per-layer path, plus its scan-stacked alias
            # ("blocks.3.attn.q" -> "blocks.attn.q", one more lead dim)
            targets = [(task["path"], lead)]
            segs = task["path"].split(".")
            if segs[0] in stacked and len(segs) > 1 and segs[1].isdigit():
                targets.append((".".join([segs[0]] + segs[2:]), lead + 1))
            for tpath, ld in targets:
                for leaf, sp in task_leaf_specs(spec["method"], ax,
                                                lead=ld).items():
                    out[f"{tpath}.{leaf}"] = NamedSharding(mesh, sp)
    if diverged:
        shown = "; ".join(diverged[:3])
        more = f" (+{len(diverged) - 3} more)" if len(diverged) > 3 else ""
        warnings.warn(
            f"restore-time bucket layout differs from the save-time "
            f"manifest for {len(diverged)} bucket(s): {shown}{more} — "
            "re-resolved against the target mesh"
            + ("/cost model" if cost_model is not None else "")
            + "; results are identical, only the sharding layout moved",
            RuntimeWarning, stacklevel=2)
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_tree(directory: str, step: int | None = None, *,
                 device: str | torch.device | None = None, shardings=None,
                 mesh=None, axis: str | None = None, cost_model=None):
    """Load ``(tree, meta)`` of step ``step`` (the newest if None).  Leaves
    are torch tensors on the CPU, or on ``device`` when given.  Raises
    ValueError naming the leaf when a stored array fails its crc32 or
    cannot be read, and FileNotFoundError when there is no complete
    step.

    ``shardings`` (``{dot.path: NamedSharding}`` or the same nested, as
    ``launch.steps.named(state_pspecs(...), mesh)`` gives it) or ``mesh``
    (the layouts
    then rebuilt from the checkpoint's bucket manifest,
    :func:`manifest_shardings`, re-decided by ``cost_model`` when given):
    each such leaf becomes a DTensor of this rank's block, on ``device`` or
    the mesh's device; a checkpoint without a manifest restores whole."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    obs_metrics.counter(obs_names.CKPT_RESTORES).inc()
    obs_trace.instant("ckpt.restore", step=int(step))
    path = os.path.join(directory, f"step_{step:08d}")
    shard = os.path.join(path, "arrays.npz")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    checksums = meta.get("checksums", {})
    try:
        data = np.load(shard)
        files = data.files
    except Exception as e:
        raise ValueError(
            f"checkpoint shard {shard} is unreadable (truncated or "
            f"corrupt archive): {e!r} — delete step_{step:08d} and restore "
            "an earlier step") from e
    if shardings is None and mesh is not None and MANIFEST_KEY in meta:
        shardings = manifest_shardings(meta[MANIFEST_KEY], mesh, axis,
                                       cost_model=cost_model)
    elif shardings is not None:       # a nested tree (launch.steps.named)
        shardings = tree_paths(shardings)
    tree: dict = {}
    for key in files:
        bf16 = key.endswith(_BF16_TAG)
        leaf_name = key[: -len(_BF16_TAG)] if bf16 else key
        try:
            arr = data[key]
        except Exception as e:
            raise ValueError(
                f"leaf {leaf_name!r} in {shard} is unreadable (shard "
                f"truncated mid-member): {e!r} — delete step_{step:08d} "
                "and restore an earlier step") from e
        if key in checksums and _crc(arr) != checksums[key]:
            raise ValueError(
                f"checksum mismatch for leaf {leaf_name!r} in {shard} — "
                "the shard is corrupt (bit rot or torn write); delete "
                f"step_{step:08d} and restore an earlier step")
        t = _tensor(arr, bf16)
        sh = None if shardings is None else shardings.get(leaf_name)
        if sh is not None:
            dev = device if device is not None else _mesh_device(sh.mesh)
            t = sh.distribute(t.to(dev))
        elif device is not None:
            t = t.to(device)
        set_path(tree, leaf_name, t)
    return tree, meta


class CheckpointManager:
    """Saves every ``every`` steps (or when forced), keeps the newest
    ``keep`` steps and every pinned one; with ``async_write`` the file
    write runs on a thread that the next save, a restore or :meth:`wait`
    joins."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.every = every
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def maybe_save(self, step: int, tree, extra_meta: dict | None = None,
                   force: bool = False, manifest: dict | None = None,
                   pin: bool = False) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        self._thread = save_tree(tree, self.directory, step, extra_meta,
                                 background=self.async_write,
                                 manifest=manifest, pin=pin)
        self._gc()
        return True

    def latest_step(self) -> int | None:
        steps = list_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *,
                device: str | torch.device | None = None, shardings=None,
                mesh=None, axis: str | None = None, cost_model=None):
        self.wait()
        return restore_tree(self.directory, step, device=device,
                            shardings=shardings, mesh=mesh, axis=axis,
                            cost_model=cost_model)

    def _gc(self) -> None:
        steps = list_steps(self.directory)
        for s in steps[: -self.keep]:
            path = os.path.join(self.directory, f"step_{s:08d}")
            if os.path.exists(os.path.join(path, PIN_MARKER)):
                continue
            shutil.rmtree(path, ignore_errors=True)


class QuantJournal:
    """Per-bucket journal of an in-progress quantization run.

    Each finished bucket is committed synchronously as one checkpoint step
    (``step == bucket index``) through :func:`save_tree`, with its
    atomicity and checksums: the leaves of the bucket's tasks under ``t<j>``
    (``j`` its position in the bucket), sites left dense as indices in
    ``meta.json``, and the tasks' health records beside them.  A restarted
    run calls :meth:`load_bucket` before computing each bucket and skips
    the ones the journal holds, bit-identical (f32/uint8 leaves round-trip
    npz exactly).

    Entries are fingerprinted over the bucket spec and the ordered task
    identities, so a journal from another recipe, model or task order is
    ignored (the bucket is recomputed) rather than restoring the wrong
    weights.  The on-disk format is the JAX package's."""

    def __init__(self, directory: str):
        self.directory = directory

    @staticmethod
    def _fingerprint(spec_dict: dict, task_ids: list) -> str:
        blob = json.dumps([spec_dict, task_ids], sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()

    def buckets(self) -> list[int]:
        return list_steps(self.directory)

    def load_bucket(self, bucket: int, spec_dict: dict, task_ids: list, *,
                    device: str | torch.device | None = None):
        """``(results, health_records)`` of a committed bucket, leaves on
        ``device``, or ``None`` when absent, stale or unreadable (then the
        bucket is recomputed).  ``results`` follows ``task_ids``: a leaf
        dict a task, ``None`` where the run left the task dense."""
        path = os.path.join(self.directory, f"step_{bucket:08d}")
        if not os.path.isfile(os.path.join(path, "meta.json")):
            return None
        try:
            tree, meta = restore_tree(self.directory, bucket, device=device)
        except (OSError, ValueError, KeyError):
            return None                       # truncated/corrupt: recompute
        if meta.get("journal_fingerprint") != \
                self._fingerprint(spec_dict, task_ids):
            return None
        dense = set(meta.get("dense", ()))
        out = []
        for j in range(len(task_ids)):
            if j in dense:
                out.append(None)
            elif f"t{j}" in tree:
                out.append(tree[f"t{j}"])
            else:
                return None                   # incomplete entry: recompute
        return out, meta.get("health", {})

    def commit_bucket(self, bucket: int, spec_dict: dict, task_ids: list,
                      results: list, health_records: dict | None = None):
        tree = {f"t{j}": r for j, r in enumerate(results) if r is not None}
        meta = {
            "journal_fingerprint": self._fingerprint(spec_dict, task_ids),
            "bucket": int(bucket),
            "dense": [j for j, r in enumerate(results) if r is None],
            "health": health_records or {},
        }
        with obs_trace.span("journal.commit", bucket=int(bucket),
                            tasks=len(task_ids)):
            save_tree(tree, self.directory, bucket, extra_meta=meta)
        obs_metrics.counter(obs_names.JOURNAL_COMMITTED).inc()
