"""Rank bodies of the port's sharded family tests
(``tests/test_torch_sharded_families.py``): run under ``repro_torch.launch.
mesh.spawn_ranks`` with 4 gloo ranks on the CPU, a ``(data 2, model 2)``
mesh.  Imports torch and ``repro_torch`` only.

``run(rank, workdir, tag)`` reads ``workdir/<tag>.inputs.pt`` (written by
the test): a dict of scenarios, each a config, an optimizer config, full
params and batches, and optionally a decode (the reference's tokens, an
enc-dec model's encoder embeddings).  Each scenario's state is laid out by
``state_pspecs``; the ranks decode its params (before training), run its
steps and gather what the test compares; rank 0 writes
``workdir/<tag>.outputs.pkl``.
"""
from __future__ import annotations

import os
import pickle

import torch

from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh, pcontext_for
from repro_torch.models import parallel
from repro_torch.models.transformer import encode, init_decode_cache
from repro_torch.optim import merge_params
from tests.torch_sharded_worker import _np, distribute_state, train


def decode(sc: dict, params, pctx) -> dict:
    """The sharded decode fed the reference's tokens (batch 4, cache 16);
    an enc-dec cache's ``enc_out`` holds each data rank's rows of the
    sharded encoder's output."""
    cfg, dec = sc["cfg"], sc["decode"]
    cache = init_decode_cache(cfg, 4, 16, device="cpu", pctx=pctx)
    if "enc_embeds" in dec:
        mine = parallel.local_of(cache["enc_out"])
        r = pctx.mesh.get_local_rank("data")
        rows = dec["enc_embeds"].chunk(2, dim=0)[r]
        with torch.no_grad():
            mine.copy_(encode(params, cfg, rows, pctx=pctx))
    step = steps.make_decode_step(cfg, pctx)
    logits = []
    with torch.no_grad():
        for tok in dec["tokens"]:
            lg, cache = step(params, cache, tok)
            logits.append(_np(lg))
    local = {k: list(parallel.local_of(v).shape)
             for k, v in cache.items() if k in ("state", "conv_x", "k")}
    return {"logits": logits, "cache_local": local}


def run(rank: int, workdir: str, tag: str) -> None:
    inp = torch.load(os.path.join(workdir, f"{tag}.inputs.pt"),
                     weights_only=False)
    mesh = make_local_mesh(2, 2, device_type="cpu")
    pctx = pcontext_for(mesh)
    out: dict = {}
    for name, sc in inp.items():
        state = distribute_state(steps.build_state(sc["params"], sc["ocfg"]),
                                 mesh)
        if "decode" in sc:
            out[f"{name}.decode"] = decode(
                sc, merge_params(state["train"], state["frozen"]), pctx)
        out[name] = train(sc, state, pctx)
    if rank == 0:
        with open(os.path.join(workdir, f"{tag}.outputs.pkl"), "wb") as f:
            pickle.dump(out, f)
