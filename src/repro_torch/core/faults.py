"""Fault-injection harness: named failure points the runtime honors.

PyTorch twin of ``repro.core.faults``: the same points, the same
``REPRO_FAULTS`` syntax, the same hooks.  Every stage of a quantization
pass has a real failure mode (an all-NaN calibration batch, a non-PSD
Gram, a torn checkpoint shard, a preemption between buckets); the health
guards (:mod:`repro_torch.core.health`), the quantization journal
(:class:`repro_torch.checkpoint.manager.QuantJournal`) and the checkpoint
checksums exist to survive them, and this module is how tests produce
them.  Each hook is a no-op unless an :class:`Injection` is armed.

Injection points
----------------
``gram_nan``
    Replace a site's calibration Gram with all-NaN where the engine reads
    it.  Target: glob over the site's param path (``blocks.0.attn.q``).
``gram_non_psd``
    Shift the Gram's spectrum strongly negative (``H - 2 tr(H)/m I``): the
    damped Cholesky fails and re-damping cannot save it.
``gram_jitter``
    Mildly deficient Gram (``H - 0.03 tr(H)/m I``): the default damping
    fails but the first re-damp rung recovers.
``calib_nan``
    One calibration batch's float inputs are NaN-filled before the forward
    and its recorded activations after it.  Target: batch index.
``calib_drop``
    Drop one calibration batch.  Target: batch index.
``shard_truncate``
    Truncate the committed ``arrays.npz`` of a checkpoint step right after
    its rename.  Target: step.
``kill_between_buckets``
    SIGKILL the process right after bucket *k*'s journal commit.  Target:
    bucket index.

Tests arm injections with the context manager::

    with faults.inject("gram_nan", match="blocks.0.attn.q"):
        quantize_model(...)

or, for a child process, with ``REPRO_FAULTS``, ``;``-separated
``point=match`` pairs::

    REPRO_FAULTS="kill_between_buckets=1" python -m repro_torch.launch.train ...

>>> with inject("gram_nan", match="blocks.0.*"):
...     active("gram_nan", "blocks.0.attn.q") is not None
True
>>> active("gram_nan", "blocks.0.attn.q") is None    # disarmed on exit
True
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os
import signal

import numpy as np
import torch

from repro_torch.core import linalg

ENV_VAR = "REPRO_FAULTS"

POINTS = ("gram_nan", "gram_non_psd", "gram_jitter", "calib_nan",
          "calib_drop", "shard_truncate", "kill_between_buckets")

# sentinel returned by corrupt_batch for a dropped batch
DROPPED = object()


@dataclasses.dataclass
class Injection:
    """One armed fault: a named point and a glob over the hook's target
    (param path, batch index, bucket index, checkpoint step), compared as
    ``fnmatch.fnmatchcase(str(target), match)``."""
    point: str
    match: str = "*"

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"options {POINTS}")

    def hits(self, target) -> bool:
        return fnmatch.fnmatchcase(str(target), self.match)


_active: list[Injection] = []
_env_cache: tuple[str, list[Injection]] | None = None


def _parse_env(value: str) -> list[Injection]:
    out = []
    for part in value.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, match = part.partition("=")
        out.append(Injection(point.strip(), match.strip() or "*"))
    return out


def _env_injections() -> list[Injection]:
    global _env_cache
    value = os.environ.get(ENV_VAR, "")
    if _env_cache is None or _env_cache[0] != value:
        _env_cache = (value, _parse_env(value))
    return _env_cache[1]


def active(point: str, target) -> Injection | None:
    """The first armed injection hitting ``(point, target)``, else None."""
    for inj in _active:
        if inj.point == point and inj.hits(target):
            return inj
    for inj in _env_injections():
        if inj.point == point and inj.hits(target):
            return inj
    return None


@contextlib.contextmanager
def inject(point: str, match: str = "*"):
    """Arm one injection for the duration of the ``with`` block."""
    inj = Injection(point, match)
    _active.append(inj)
    try:
        yield inj
    finally:
        _active.remove(inj)


# ---------------------------------------------------------------------------
# Hooks, called by the runtime at the matching failure point.
# ---------------------------------------------------------------------------


def corrupt_gram(path: str, H: torch.Tensor | None):
    """Gram-read hook (``pipeline._site_gram``): NaN / non-PSD / mildly
    deficient copy of the Gram the engine is about to consume, on its
    device.  Identity when nothing is armed or ``H`` is None."""
    if H is None:
        return H
    if active("gram_nan", path) is not None:
        return torch.full_like(H, float("nan"), dtype=torch.float32)
    Ha = H.float()
    m = Ha.shape[-1]
    eye = torch.eye(m, dtype=torch.float32, device=Ha.device)
    scale = (linalg.trace(Ha) / m)[..., None, None]
    if active("gram_non_psd", path) is not None:
        return Ha - 2.0 * scale * eye
    if active("gram_jitter", path) is not None:
        return Ha - 0.03 * scale * eye
    return H


def _poison(leaf):
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
        return torch.full_like(leaf, float("nan"))
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                      np.floating):
        return np.full_like(leaf, np.nan)
    return leaf


def corrupt_batch(index: int, batch: dict):
    """Calibration-batch hook (``pipeline.run_calibration``): the batch
    unchanged, a copy with its float leaves NaN-filled, or
    :data:`DROPPED`."""
    if active("calib_drop", index) is not None:
        return DROPPED
    if active("calib_nan", index) is not None:
        return {k: _poison(v) for k, v in batch.items()}
    return batch


def poison_grams(index: int, store) -> None:
    """Post-forward hook paired with ``calib_nan``: NaN-fill the
    activations batch ``index`` recorded (its ``utils.ActivationLog``:
    what a non-finite forward would leave, whether or not the batch had
    float leaves)."""
    if active("calib_nan", index) is None:
        return
    store.poison()


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate ``path`` to ``keep_fraction`` of its size (the torn write
    behind ``shard_truncate``)."""
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(int(size * keep_fraction), 1))


def post_commit(step_dir: str, step: int) -> None:
    """Checkpoint-commit hook (``checkpoint.manager.save_tree``): truncate
    the just-committed shard when ``shard_truncate`` is armed for this
    step."""
    if active("shard_truncate", step) is None:
        return
    arrays = os.path.join(step_dir, "arrays.npz")
    if os.path.exists(arrays):
        truncate_file(arrays)


def maybe_kill(point: str, target) -> None:
    """Hard-death hook (``kill_between_buckets``): SIGKILL this process,
    with no handler, flush or exit hook; only the journal's atomic commits
    survive."""
    if active(point, target) is None:
        return
    os.kill(os.getpid(), signal.SIGKILL)
