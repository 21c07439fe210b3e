"""Parallel context threaded through model apply functions.

Only the single-device context exists in the port so far; ``mesh`` is kept
so that signatures match ``repro.models.parallel``."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PContext:
    """Mesh + axis-name bundle.  ``mesh=None`` => single-device eager path."""
    mesh: Any = None
    data_axes: Any = "data"
    model_axis: str = "model"


LOCAL = PContext()
