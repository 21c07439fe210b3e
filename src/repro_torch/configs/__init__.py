"""Architecture registry: ``get_config(name)`` / ``get_smoke_config``.

Every module defines ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  All
ten architectures of ``repro.configs`` are ported: dense, MoE, SSM,
hybrid, enc-dec (seamless-m4t-medium) and the vision-prefix dense model
(pixtral-12b).
"""
from __future__ import annotations

import dataclasses
import importlib

# the reference's order (repro.configs.ARCH_IDS)
ARCH_IDS = [
    "qwen3_moe_30b_a3b",
    "olmoe_1b_7b",
    "qwen3_4b",
    "codeqwen15_7b",
    "qwen3_1p7b",
    "minicpm_2b",
    "zamba2_7b",
    "seamless_m4t_medium",
    "mamba2_370m",
    "pixtral_12b",
]

# dashes-to-underscores aliases matching the assignment sheet names
ALIASES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-4b": "qwen3_4b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-1.7b": "qwen3_1p7b",
    "minicpm-2b": "minicpm_2b",
    "zamba2-7b": "zamba2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-370m": "mamba2_370m",
    "pixtral-12b": "pixtral_12b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
