"""LR schedules: constant / linear / cosine / WSD (warmup-stable-decay,
MiniCPM, arXiv:2404.06395).  PyTorch twin of ``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_frac: float = 0.03, min_ratio: float = 0.1,
                  decay_frac: float = 0.1):
    """Returns step -> lr, a 0-d f32 tensor on the step's device (a Python
    number counts as a CPU step), computed in f32 as the JAX twin does."""
    if kind not in ("const", "linear", "cosine", "wsd"):
        raise ValueError(f"unknown schedule {kind}")
    warmup = max(int(total_steps * warmup_frac), 1)

    def sched(step):
        s = torch.as_tensor(step).to(torch.float32)
        wu = torch.clamp(s / warmup, max=1.0)
        if kind == "const":
            post = torch.ones_like(s)
        elif kind == "linear":
            t = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                            0.0, 1.0)
            post = 1.0 - (1.0 - min_ratio) * t
        elif kind == "cosine":
            t = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                            0.0, 1.0)
            post = min_ratio + (1.0 - min_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        else:                                       # wsd
            decay_start = total_steps * (1.0 - decay_frac)
            t = torch.clamp((s - decay_start)
                            / max(total_steps - decay_start, 1), 0.0, 1.0)
            post = 1.0 - (1.0 - min_ratio) * t      # stable, then linear decay
        return base_lr * wu * post

    return sched
