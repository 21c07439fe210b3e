"""Architecture registry: ``get_config(name)`` / ``get_smoke_config``.

Every module defines ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  Only the
dense Qwen3 family is ported so far; the other architectures of
``repro.configs`` are listed in ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "qwen3_1p7b",
]

# dashes-to-underscores aliases matching the assignment sheet names
ALIASES = {
    "qwen3-1.7b": "qwen3_1p7b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_IDS} (other "
                       "architectures are not ported yet, see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
