"""GQA attention with RoPE, optional qk-norm, sliding window and KV-cache
decode, and the enc-dec model's cross-attention.  PyTorch twin of
``repro.models.attention``.
Shapes: x (B, S, D); heads laid out as (B, S, H, hd).  Softmax in f32.

Under a mesh (leaves sharded over "model", ``models.parallel``) each rank
attends with the heads its q/k/v column shards hold.  Where a layout
splits a head or breaks the GQA grouping, the projection is gathered to
whole heads, as GSPMD would compute it (:func:`_shard_heads`).  A decode
cache sharded along its sequence (``launch.shardings.cache_specs`` where
the model axis does not divide the KV heads) is decoded by a distributed
softmax: every rank attends every head over its own keys and the ranks'
partials are combined (:func:`_decode_seq_sharded`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import parallel
from repro_torch.models.modules import (QSpec, linear_apply, linear_init,
                                        rmsnorm_apply, rmsnorm_init)
from repro_torch.utils import scope

Tensor = torch.Tensor
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: int | None = None   # None = full attention
    causal: bool = True
    bias: bool = False                  # qwen1.5-style qkv bias

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attn_init(gen: torch.Generator, cfg: AttnConfig, *, dtype=torch.bfloat16,
              lora_rank: int = 0, device=None) -> dict:
    hd = cfg.hd
    kw = dict(dtype=dtype, lora_rank=lora_rank, device=device)
    p = {
        "q": linear_init(gen, cfg.d_model, cfg.n_heads * hd, bias=cfg.bias,
                         **kw),
        "k": linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.bias,
                         **kw),
        "v": linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.bias,
                         **kw),
        "o": linear_init(gen, cfg.n_heads * hd, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _tp_group(p: dict):
    """The model axis's group when a projection of ``p`` is sharded over
    it, else None."""
    return parallel.model_group({k: p[k] for k in ("q", "k", "v", "o")
                                 if k in p})


def _shard_heads(cfg: AttnConfig, q: Tensor, k: Tensor, v: Tensor, group,
                 whole: bool = False):
    """q, k, v projections (B, S, cols) as heads (B, S, h, hd) (k and v
    may have another S: cross-attention), and whether the heads differ
    from rank to rank.  ``whole``: every projection gathered to all its
    heads (the sequence-sharded decode).  Otherwise the rank keeps its q
    heads when
    its q columns hold whole heads of a head count the axis divides; its
    k/v columns then serve them when they hold the matching whole KV
    heads, else k/v are gathered whole (their gradient reduce-scattered, or
    summed when replicated) and each local q head takes its own KV head.
    Otherwise every projection is gathered and every rank attends with all
    heads (the gradient sliced)."""
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    n = parallel.group_size(group)
    heads = (lambda t: t.reshape(*t.shape[:2], -1, hd))
    if group is None or n == 1:
        return heads(q), heads(k), heads(v), False
    if not whole and q.shape[-1] * n == Hq * hd and q.shape[-1] % hd == 0 \
            and Hq % n == 0:
        hq = q.shape[-1] // hd
        if k.shape[-1] * n == Hkv * hd and Hkv % n == 0 and \
                (Hkv // n) * hd == k.shape[-1]:
            return heads(q), heads(k), heads(v), True
        rep = Hq // Hkv
        q0 = torch.distributed.get_rank(group) * hq
        idx = (q0 + torch.arange(hq, device=q.device)) // rep

        def kv_whole(t):
            if t.shape[-1] == Hkv * hd:       # replicated: summed gradient
                t = parallel.copy_to(t, group)
            else:
                t = parallel.gather_from(t, group, -1, reduce_grad=True)
            return heads(t)[:, :, idx]
        return heads(q), kv_whole(k), kv_whole(v), True

    def whole(t, H):
        if t.shape[-1] == H * hd:
            return heads(t)
        return heads(parallel.gather_from(t, group, -1, reduce_grad=False))
    return whole(q, Hq), whole(k, Hkv), whole(v, Hkv), False


def _project_qkv(p, cfg: AttnConfig, x: Tensor, positions: Tensor | None,
                 qspec: QSpec | None, kv_src: Tensor | None = None,
                 whole: bool = False):
    """q from ``x``, k and v from ``kv_src`` (``x`` when None), as the
    rank's heads (:func:`_shard_heads`; all heads with ``whole``),
    qk-normed and, given ``positions``, roped."""
    kv_src = x if kv_src is None else kv_src
    with scope("q"):
        q = linear_apply(p["q"], x, qspec)
    with scope("k"):
        k = linear_apply(p["k"], kv_src, qspec)
    with scope("v"):
        v = linear_apply(p["v"], kv_src, qspec)
    group = _tp_group(p)
    q, k, v, sharded = _shard_heads(cfg, q, k, v, group, whole)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if sharded:          # applied to the rank's heads: summed grads
            qn = {"scale": parallel.copy_to(qn["scale"], group)}
            kn = {"scale": parallel.copy_to(kn["scale"], group)}
        q = rmsnorm_apply(qn, q)
        k = rmsnorm_apply(kn, k)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None) -> Tensor:
    """q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd); GQA via head grouping; f32 out."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(B, Sq, Hq, hd)


def causal_mask(Sq: int, Sk: int, window: int | None = None,
                offset: int = 0, device=None) -> Tensor:
    """(1,1,1,Sq,Sk) boolean mask; offset = absolute position of query 0."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None, :, :]


def attn_apply(p, cfg: AttnConfig, x: Tensor, *, qspec: QSpec | None = None,
               positions: Tensor | None = None,
               q_chunk: int | None = None) -> Tensor:
    """Full (training / prefill) self-attention.

    ``q_chunk``: blockwise query chunking, when ``S > q_chunk`` and
    ``q_chunk`` divides S: each block of ``q_chunk`` queries attends to
    all S keys under its own mask offset, softmax in f32, so the peak
    logits memory falls from O(S^2) to O(q_chunk * S) a head with the same
    math (the JAX twin's unrolled blocks)."""
    B, S, _ = x.shape
    positions = (torch.arange(S, device=x.device) if positions is None
                 else positions)
    q, k, v = _project_qkv(p, cfg, x, positions, qspec)
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = []
        for i in range(S // q_chunk):
            qi = q[:, i * q_chunk:(i + 1) * q_chunk]
            mask = (causal_mask(q_chunk, S, cfg.sliding_window,
                                offset=i * q_chunk, device=x.device)
                    if cfg.causal else None)
            outs.append(_sdpa(qi, k, v, mask))
        out = torch.cat(outs, dim=1)
    else:
        mask = (causal_mask(S, S, cfg.sliding_window, device=x.device)
                if cfg.causal else None)
        out = _sdpa(q, k, v, mask)
    with scope("o"):
        return linear_apply(p["o"], out.reshape(B, S, -1).to(x.dtype), qspec)


def attn_decode(p, cfg: AttnConfig, x: Tensor, cache: dict, *,
                qspec: QSpec | None = None) -> tuple[Tensor, dict]:
    """Single-token decode.  cache = {"k": (B,T,Hkv,hd), "v": ..., "idx"}.

    ``idx`` is a 0-d integer tensor (every row at the same position) or a
    (B,) vector (each row writes, ropes and masks at its own position).
    The new K/V rows are written into ``cache["k"]``/``cache["v"]`` in
    place (the JAX twin returns updated copies; writing in place saves a
    copy of the cache per layer and step), and the same tensors are
    returned.

    With ``qspec.use_kernel`` (full attention only) the masked softmax runs
    through the flash-attention kernel's per-sequence ``lengths`` operand
    (``idx + 1``) instead of the dense mask — same math.  With a sliding
    window the cache is a ring buffer of size window.

    A cache tagged as sharded along T over "model" (a sequence-sharded
    cache's layer, ``parallel.select_layer``) takes
    :func:`_decode_seq_sharded`."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError("decode processes one token")
    idx = cache["idx"]
    vec = idx.dim() == 1
    positions = idx[:, None] if vec else idx.reshape(1, 1).expand(B, 1)
    K, V = cache["k"], cache["v"]
    seq = _seq_shard(K, cfg)
    q, k, v = _project_qkv(p, cfg, x, positions, qspec,
                           whole=seq is not None)
    if seq is not None:
        out = _decode_seq_sharded(q, k, v, K, V, idx, seq, qspec)
        with scope("o"):
            y = linear_apply(p["o"], out.reshape(B, 1, -1).to(x.dtype),
                             qspec)
        return y, {"k": K, "v": V, "idx": idx + 1}
    if k.shape[2] != K.shape[2]:
        raise ValueError(
            f"sharded decode: the rank's projections give {k.shape[2]} KV "
            f"heads, its cache holds {K.shape[2]}: the cache is not laid "
            "out by launch.shardings.cache_specs")
    T = K.shape[1]
    slot = torch.remainder(idx, T) if cfg.sliding_window else idx
    if vec:
        rows = torch.arange(B, device=x.device)
        K[rows, slot.long()] = k[:, 0].to(K.dtype)
        V[rows, slot.long()] = v[:, 0].to(V.dtype)
    else:
        at = slot.reshape(1).long()
        K.index_copy_(1, at, k.to(K.dtype))
        V.index_copy_(1, at, v.to(V.dtype))
    if qspec is not None and qspec.use_kernel and not cfg.sliding_window:
        from repro_torch.kernels import ops as kops
        counts = (idx + 1) if vec else (idx + 1).reshape(1).expand(B)
        out = kops.flash_attention(
            q.transpose(1, 2), K.transpose(1, 2), V.transpose(1, 2),
            causal=False,
            lengths=counts.to(torch.int32).contiguous()).transpose(1, 2)
    else:
        kpos = torch.arange(T, device=x.device)
        pos = idx[:, None] if vec else idx
        if cfg.sliding_window:
            valid = (kpos <= torch.clamp(pos, max=T - 1)) | (pos >= T)
        else:
            valid = kpos <= pos
        mask = (valid[:, None, None, None, :] if valid.dim() == 2
                else valid[None, None, None, None, :])
        out = _sdpa(q, K, V, mask)
    with scope("o"):
        y = linear_apply(p["o"], out.reshape(B, 1, -1).to(x.dtype), qspec)
    return y, {"k": K, "v": V, "idx": idx + 1}


def _seq_shard(K: Tensor, cfg: AttnConfig):
    """(group, rank, keys a rank) of a layer's cache ``K`` (B, T, Hkv, hd)
    tagged as sharded along T over "model", else None."""
    lay = parallel.layout_of(K)
    if lay is None or lay.dim_of("model") != 1:
        return None
    if cfg.sliding_window:
        raise NotImplementedError(
            "a sliding-window KV cache sharded along its sequence (a ring "
            "buffer split over the model axis) is not supported: no config "
            "lays one out, since cache_specs shards a windowed cache's KV "
            "heads, which the model axis divides in every config")
    return (parallel.axis_group(lay.mesh, "model"),
            parallel.axis_rank(lay.mesh, "model"), K.shape[1])


def _decode_seq_sharded(q: Tensor, k: Tensor, v: Tensor, K: Tensor,
                        V: Tensor, idx: Tensor, seq: tuple,
                        qspec: QSpec | None) -> Tensor:
    """One decode token over a cache sharded along T: rank r holds global
    positions ``[r T_l, (r + 1) T_l)``.  q (B, 1, Hq, hd) and k/v
    (B, 1, Hkv, hd) hold every head.  The new K/V row is written by mask,
    not by a host branch: each rank writes ``where(in_shard, new, old)`` at
    ``clamp(idx - r T_l, 0, T_l - 1)``, so a vector ``idx`` whose rows lie
    in different shards writes each on its own rank, and meta tensors
    pass.  Every q head attends the rank's ``clamp(idx + 1 - r T_l, 0,
    T_l)`` valid keys by the partial flash attention (the kernel under
    ``qspec.use_kernel``, else its plain version), and the ranks' partials
    are combined over "model" (``parallel.combine_softmax``).  Returns
    (B, 1, Hq, hd) f32, the same on every rank."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    group, r, T = seq
    B = q.shape[0]
    pos = idx if idx.dim() == 1 else idx.reshape(1).expand(B)
    local = pos - r * T
    inside = ((local >= 0) & (local < T))[:, None, None]
    at = local.clamp(0, T - 1).long()
    rows = torch.arange(B, device=q.device)
    for C, new in ((K, k), (V, v)):
        C[rows, at] = torch.where(inside, new[:, 0].to(C.dtype), C[rows, at])
    lengths = (local + 1).clamp(0, T).to(torch.int32).contiguous()
    attend = (kops.flash_attention if qspec is not None and qspec.use_kernel
              else kref.flash_attention_ref)
    o, lse = attend(q.transpose(1, 2), K.transpose(1, 2), V.transpose(1, 2),
                    causal=False, lengths=lengths, return_lse=True)
    return parallel.combine_softmax(o[:, :, 0], lse[:, :, 0], group)[:, None]


def cross_attn_apply(p, cfg: AttnConfig, x: Tensor, kv_src: Tensor, *,
                     qspec: QSpec | None = None) -> Tensor:
    """Encoder-decoder cross-attention: queries from ``x`` (B, Sq, D), keys
    and values projected from ``kv_src`` (B, Sk, D); no RoPE and no mask
    (the plain softmax, as the JAX twin: no kernel runs here).  Under a
    mesh each rank attends with its heads, ``kv_src`` whole along Sk."""
    B, Sq, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, None, qspec, kv_src=kv_src)
    out = _sdpa(q, k, v, None)
    with scope("o"):
        return linear_apply(p["o"], out.reshape(B, Sq, -1).to(x.dtype), qspec)
