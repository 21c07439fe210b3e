"""Mixture-of-Experts block.  PyTorch twin of ``repro.models.moe`` without
a mesh.

Tokens are routed by a float32 router (softmax, top-k, renormalized) and
dispatched by a stable sort over expert ids into a static ``(E, C, D)``
capacity buffer; tokens past an expert's capacity ``C`` are dropped, the
same ones as in the JAX twin (``jnp.argsort(stable=True)`` there,
``torch.sort(stable=True)`` here).  The expert products are batched
``einsum``s over the stack, dequantized from packed codes for a quantized
model, as the JAX twin computes them outside any Pallas kernel.

Every shape is static and nothing reads a tensor's value on the host (no
``bincount``, ``nonzero``, ``one_hot`` or ``.item()``), so a decode step
through this block can be captured as a CUDA graph.  The combine puts each
token's ``k`` contributions back in token order through the inverse
permutation and sums them, so it is deterministic on the card (no
atomics).

Under a mesh (``pctx.mesh``, expert stacks sharded on E over "model", the
twin's ``shard_map``): each rank routes its data shard's tokens (the same
on every model rank), dispatches them to its ``E / n_model`` experts only
(offset by its model rank, capacity from the local token count), and the
ranks' outputs are summed over "model"; ``aux`` is the mean of the data
shards' load-balance losses (the twin's ``pmean``).  The gradients that a
rank's experts see only in part (the routing weights', the dispatched
tokens') are summed over "model" (``parallel.copy_to``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator

import torch
import torch.nn.functional as F

from repro_torch.core.quantizer import (dequantize_int, dequantize_nf4,
                                        unpack_codes)
from repro_torch.models import parallel
from repro_torch.models.modules import QSpec, packed_bits
from repro_torch.utils import (current_scope, is_recomputing,
                               record_activation, scope)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    norm_topk: bool = True         # renormalize selected probs (qwen3 style)
    router_aux_weight: float = 0.01


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, dtype=torch.bfloat16,
             lora_rank: int = 0, device=None) -> dict:
    """Random params with the JAX twin's shapes, dtypes and scales: an f32
    router ``(D, E)``, expert stacks ``(E, m, n)`` and, with ``lora_rank``,
    a LoRA pair an expert (``lora_b`` zero)."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    def stack(m, n):
        return (randn((E, m, n)) / math.sqrt(m)).to(dtype)

    p = {"router": {"w": randn((D, E)) * 0.02},
         "gate": {"w": stack(D, Fd)},
         "up": {"w": stack(D, Fd)},
         "down": {"w": stack(Fd, D)}}
    if lora_rank:
        for name, m, n in (("gate", D, Fd), ("up", D, Fd), ("down", Fd, D)):
            p[name]["lora_a"] = (randn((E, m, lora_rank))
                                 / math.sqrt(m)).to(dtype)
            p[name]["lora_b"] = torch.zeros((E, n, lora_rank), dtype=dtype,
                                            device=device)
    return p


def _expert_matmul(pd: dict, buf: Tensor, qspec: QSpec | None) -> Tensor:
    """buf (E, C, m) @ per-expert weights (E, m, n) -> (E, C, n)."""
    m = buf.shape[-1]
    if "qcodes" in pd:
        if qspec is None:
            raise ValueError("quantized params need a QSpec")
        if "absmax" in pd:                     # NF4 (QLoRA baseline)
            codes = unpack_codes(pd["qcodes"], 4, m)
            w = dequantize_nf4(codes, pd["absmax"],
                               m // pd["absmax"].shape[-2], buf.dtype)
        else:
            # bits and group from the stored shapes, as linear_apply does
            bits = packed_bits(pd["qcodes"].shape[-2], m)
            codes = unpack_codes(pd["qcodes"], bits, m)
            w = dequantize_int(codes, pd["scales"], pd["zeros"],
                               m // pd["scales"].shape[-2], dtype=buf.dtype)
    else:
        w = pd["w"].to(buf.dtype)
    y = torch.einsum("ecm,emn->ecn", buf, w)
    if "lora_a" in pd:
        a = pd["lora_a"].to(buf.dtype)
        b = pd["lora_b"].to(buf.dtype)
        y = y + torch.einsum("ecr,enr->ecn",
                             torch.einsum("ecm,emr->ecr", buf, a), b)
    return y


def _route(router_w: Tensor, xt: Tensor, cfg: MoEConfig):
    """Returns (topw (T, k) f32, topi (T, k) int64, aux_loss scalar)."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss: E * sum_e f_e * P_e, with the
    # top-1 one-hot built by comparison (F.one_hot reads its input's range
    # on the host)
    E = cfg.n_experts
    experts = torch.arange(E, device=xt.device)
    f = (topi[:, :1] == experts).float().mean(dim=0)
    P = probs.mean(dim=0)
    aux = E * (f * P).sum()
    return topw, topi, aux


# when a list, each dispatch appends (dropped slots, routed slots) as
# device tensors (see record_drops)
_drop_log: list | None = None


@contextlib.contextmanager
def record_drops() -> Iterator[list]:
    """Collect ``(dropped, routed)`` token-slot counts of every dispatch
    run inside the block, as 0-d device tensors (nothing is read on the
    host until the caller does): one record a dispatch a forward, none
    from a checkpointed region's recompute in the backward."""
    global _drop_log
    prev, _drop_log = _drop_log, []
    try:
        yield _drop_log
    finally:
        _drop_log = prev


def _dispatch_compute_combine(p: dict, cfg: MoEConfig, xt: Tensor,
                              topw: Tensor, topi: Tensor, capacity: int,
                              qspec: QSpec | None, e_start: int = 0,
                              e_local: int | None = None) -> Tensor:
    """Route the tokens xt (T, D) to the experts ``[e_start, e_start +
    e_local)`` (all of them by default) through a static (e_local, C, D)
    buffer, run those experts and combine their weighted outputs (zero
    from the other experts)."""
    T, D = xt.shape
    k = cfg.top_k
    E = cfg.n_experts if e_local is None else e_local
    flat_e = topi.reshape(-1) - e_start                      # (T*k,)
    flat_w = topw.reshape(-1)
    mine = (flat_e >= 0) & (flat_e < E)
    flat_e = torch.where(mine, flat_e, E)                    # overflow id
    # position within expert, by a stable sort over expert id
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.long, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=xt.device) - starts[sorted_e]
    routed = sorted_e < E
    keep = (pos_in_e < capacity) & routed
    dest = torch.where(keep, sorted_e * capacity + pos_in_e,
                       torch.full_like(pos_in_e, E * capacity))
    if _drop_log is not None and not is_recomputing():  # once a forward
        _drop_log.append(((routed & ~keep).sum(), keep.numel()
                          if e_local is None else routed.sum()))
    token_id = sort_idx // k
    # the overflow row (last) takes every dropped slot and is discarded
    buf = torch.zeros((E * capacity + 1, D), dtype=xt.dtype,
                      device=xt.device)
    buf = buf.index_copy(0, dest, xt[token_id])
    buf = buf[:-1].reshape(E, capacity, D)

    with scope("gate"):
        record_activation(current_scope(), buf, keep_leading=True)
        g = _expert_matmul(p["gate"], buf, qspec)
    with scope("up"):
        record_activation(current_scope(), buf, keep_leading=True)
        u = _expert_matmul(p["up"], buf, qspec)
    h = F.silu(g.float()).to(buf.dtype) * u
    with scope("down"):
        record_activation(current_scope(), h, keep_leading=True)
        yb = _expert_matmul(p["down"], h, qspec)             # (E, C, D)

    y_flat = torch.cat([yb.reshape(E * capacity, D),
                        yb.new_zeros((1, D))], 0)
    w = (flat_w[sort_idx] * keep).to(yb.dtype)
    contrib = y_flat[dest] * w[:, None]                      # sorted order
    # back to token order (flat slot t * k + j), then sum each token's k
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(T * k, device=xt.device)
    return contrib[inv].reshape(T, k, D).sum(dim=1)


def moe_capacity(cfg: MoEConfig, tokens_local: int) -> int:
    c = int(tokens_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 4)


def moe_apply(p: dict, cfg: MoEConfig, x: Tensor, *,
              qspec: QSpec | None = None, pctx=None) -> tuple[Tensor, Tensor]:
    """Returns (y (B, S, D), aux_loss scalar f32).  Under ``pctx.mesh``,
    ``x`` holds the rank's data shard (module docstring)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    mesh = getattr(pctx, "mesh", None)
    if mesh is None:
        topw, topi, aux = _route(p["router"]["w"], xt, cfg)
        C = moe_capacity(cfg, xt.shape[0])
        y = _dispatch_compute_combine(p, cfg, xt, topw, topi, C, qspec)
        return y.reshape(B, S, D), aux
    stack = p["gate"].get("qcodes", p["gate"].get("w"))
    lay = parallel.layout_of(stack)
    e_dim = None if lay is None else lay.dim_of(pctx.model_axis)
    if e_dim is not None and e_dim != stack.dim() - 3:
        raise ValueError(f"expert stacks sharded on dim {e_dim}, not on "
                         "the expert dim")
    topw, topi, aux = _route(p["router"]["w"], xt, cfg)
    C = moe_capacity(cfg, xt.shape[0])          # the local token count
    if e_dim is None:                # experts whole: every rank runs them
        y = _dispatch_compute_combine(p, cfg, xt, topw, topi, C, qspec)
    else:
        mgroup = parallel.axis_group(mesh, pctx.model_axis)
        e_local = cfg.n_experts // parallel.group_size(mgroup)
        e_start = torch.distributed.get_rank(mgroup) * e_local
        ew = {k: p[k] for k in ("gate", "up", "down")}
        y = _dispatch_compute_combine(
            ew, cfg, parallel.copy_to(xt, mgroup),
            parallel.copy_to(topw, mgroup), topi, C, qspec, e_start, e_local)
        y = parallel.reduce_from(y, mgroup)
    for ax in parallel.data_axis_tuple(pctx):
        dgroup = parallel.axis_group(mesh, ax)
        aux = parallel.reduce_from(aux, dgroup) / parallel.group_size(dgroup)
    return y.reshape(B, S, D), aux
