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
atomics).  Expert parallelism (``pctx.mesh``) is not ported yet
(``ROADMAP.md``).
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
                              qspec: QSpec | None) -> Tensor:
    """Route the tokens xt (T, D) to their experts through a static
    (E, C, D) buffer, run the experts and combine their weighted outputs."""
    T, D = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    flat_e = topi.reshape(-1)                                # (T*k,)
    flat_w = topw.reshape(-1)
    # position within expert, by a stable sort over expert id
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.long, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=xt.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    dest = torch.where(keep, sorted_e * capacity + pos_in_e,
                       torch.full_like(pos_in_e, E * capacity))
    if _drop_log is not None and not is_recomputing():  # once a forward
        _drop_log.append(((~keep).sum(), keep.numel()))
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
    """Returns (y (B, S, D), aux_loss scalar f32)."""
    if pctx is not None and getattr(pctx, "mesh", None) is not None:
        raise NotImplementedError(
            "moe_apply: expert parallelism over a mesh is not ported to "
            "repro_torch yet; it comes with the training-side distribution "
            "slice (see ROADMAP.md)")
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    topw, topi, aux = _route(p["router"]["w"], xt, cfg)
    C = moe_capacity(cfg, xt.shape[0])
    y = _dispatch_compute_combine(p, cfg, xt, topw, topi, C, qspec)
    return y.reshape(B, S, D), aux
