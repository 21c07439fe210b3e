"""Step builders shared by the launchers.  Twin of the decode part of
``repro.launch.steps`` (the training and dry-run builders are later slices
of the port)."""
from __future__ import annotations

from repro_torch.models.parallel import PContext
from repro_torch.models.transformer import ModelConfig, decode_step


def make_decode_step(cfg: ModelConfig, pctx: PContext):
    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens, pctx=pctx)

    return step
