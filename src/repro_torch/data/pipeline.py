"""Deterministic, resumable token pipeline.  Twin of ``repro.data.pipeline``.

The synthetic corpus is a seeded Zipf-unigram + affine-Markov mixture and a
pure function of ``(seed, step)``, drawn with numpy exactly as the JAX
package draws it, so a batch is byte-identical in both packages.  Kind
``"encdec"`` adds ``enc_embeds`` (B, enc_len, d_model) and ``"vlm"``
``prefix_embeds`` (B, n_prefix, d_model): f32 standard normals drawn from
the batch's generator after the tokens, the frontend stubs' outputs.
Batches are CPU tensors; callers move them to their device.  Every rank
of a mesh reads the same stream and keeps its rows of each global batch
(:func:`shard_batch` by :func:`make_batch_specs`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"              # lm | encdec | vlm
    enc_len: int = 0
    n_prefix: int = 0
    d_model: int = 0
    markov_p: float = 0.7         # P(next token = affine map of current)
    zipf_a: float = 1.3


KINDS = ("lm", "encdec", "vlm")


def data_kind(cfg) -> str:
    """The data kind a model config reads (the JAX CLIs' choice): its
    frontend stub's embeddings beside the tokens, or none."""
    return ("encdec" if cfg.family == "encdec"
            else "vlm" if cfg.frontend == "vision" else "lm")


class TokenStream:
    """Deterministic resumable iterator of training batches."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        if cfg.kind not in KINDS:
            raise ValueError(f"unknown data kind {cfg.kind!r}; options "
                             f"{KINDS}")
        self.cfg = cfg
        self.step = int(step)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._zipf = probs / probs.sum()

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, st: dict) -> None:
        if st["seed"] != self.cfg.seed:
            raise ValueError("data seed mismatch on restore")
        self.step = int(st["step"])

    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        cfg = self.cfg
        first = rng.choice(cfg.vocab, size=(b,), p=self._zipf)
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = first
        a_coef = 31
        b_coef = 7
        for t in range(1, s):
            markov = (a_coef * toks[:, t - 1] + b_coef) % cfg.vocab
            fresh = rng.choice(cfg.vocab, size=(b,), p=self._zipf)
            use_markov = rng.random(b) < cfg.markov_p
            toks[:, t] = np.where(use_markov, markov, fresh)
        return toks.astype(np.int32)

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ self.step)
        self.step += 1
        toks = self._tokens(rng, cfg.global_batch, cfg.seq_len + 1)
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                 "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
        extra = {"encdec": ("enc_embeds", cfg.enc_len),
                 "vlm": ("prefix_embeds", cfg.n_prefix)}.get(cfg.kind)
        if extra is not None:
            name, length = extra
            batch[name] = torch.from_numpy(rng.standard_normal(
                (cfg.global_batch, length, cfg.d_model)).astype(np.float32))
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()


def make_batch_specs(kind: str, data_axes) -> dict:
    """Layouts of a batch dict: the batch dim over the data mesh axes."""
    dp = data_axes
    specs = {"tokens": (dp, None), "labels": (dp, None)}
    if kind == "encdec":
        specs["enc_embeds"] = (dp, None, None)
    elif kind == "vlm":
        specs["prefix_embeds"] = (dp, None, None)
    return specs


def shard_batch(batch: dict, specs: dict, mesh) -> dict:
    """This rank's block of each leaf of a global ``batch`` under
    ``specs`` on ``mesh`` (a dim named by one axis or a tuple of axes is
    split over them in order; leaves without a layout stay whole)."""
    names = tuple(mesh.mesh_dim_names)
    out = {}
    for k, v in batch.items():
        for d, ax in enumerate(specs.get(k, ())):
            for a in (() if ax is None else (ax,) if isinstance(ax, str)
                      else tuple(ax)):
                if a not in names:
                    continue
                n = int(mesh.size(names.index(a)))
                if v.shape[d] % n:
                    raise ValueError(f"batch leaf {k!r} dim {d} "
                                     f"({v.shape[d]}) does not split over "
                                     f"{a!r} ({n} ranks)")
                r = int(mesh.get_local_rank(a))
                step = v.shape[d] // n
                v = v.narrow(d, r * step, step)
        out[k] = v
    return out
