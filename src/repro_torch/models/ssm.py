"""Mamba2 / SSD (state-space duality) block.  PyTorch twin of
``repro.models.ssm``.

Training and prefill use the chunked SSD algorithm (Dao & Gu 2024):
attention-like products within chunks and a linear recurrence over the
chunks' end states (a Python loop over chunks, the JAX twin's
``lax.scan``).  Decode is the O(1)-a-token recurrent update of the (B, H,
P, N) state.

The projections are separate linears (z_proj / x_proj / bc_proj / dt_proj,
then out_proj), each through the quantizable ``linear_apply``, as in the
JAX package, so CLoQ reaches every SSM linear.  The scan's arithmetic is
f32 at the JAX twin's points: x, B, C and dt are widened before the scan,
``A = -exp(a_log)``, ``dt = softplus(dt + dt_bias)``, and the gated norm
is ``rmsnorm(y * silu(z).to(x.dtype))``.

Under a mesh (tagged local shards, ``models.parallel``) ``z_proj`` and
``x_proj`` give the rank's channels and ``conv_x`` convolves them; where
they are whole heads, each rank scans its heads: ``dt``, ``a_log``, ``d``,
``dt_bias``, the groups of B and C its heads read and its slice of the
gated norm's scale are taken from the replicated leaves by
``parallel.rank_part`` (their gradients summed over "model"), the gated
norm's sum of squares is summed over "model" (``rmsnorm_apply(group=)``),
and the row-sharded ``out_proj`` sums the ranks' parts.  Where the rank's
channels split a head, ``z`` and ``x`` are gathered whole and every rank
computes every head (the JAX twin's GSPMD layout computes the same model
either way).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import parallel
from repro_torch.models.modules import (QSpec, _randn, linear_apply,
                                        linear_init, rmsnorm_apply,
                                        rmsnorm_init)
from repro_torch.utils import scope

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128            # N
    head_dim: int = 64            # P
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def d_bc(self) -> int:
        return 2 * self.n_groups * self.d_state


def mamba_init(gen: torch.Generator, cfg: SSMConfig, *,
               dtype=torch.bfloat16, lora_rank: int = 0,
               device=None) -> dict:
    """Params with the JAX twin's shapes, dtypes and scales (``a_log``,
    ``d`` and ``dt_bias`` f32), drawn from ``gen``."""
    h = cfg.n_heads
    kw = dict(dtype=dtype, lora_rank=lora_rank, device=device)
    k = cfg.conv_kernel
    return {
        "z_proj": linear_init(gen, cfg.d_model, cfg.d_inner, **kw),
        "x_proj": linear_init(gen, cfg.d_model, cfg.d_inner, **kw),
        "bc_proj": linear_init(gen, cfg.d_model, cfg.d_bc, **kw),
        "dt_proj": linear_init(gen, cfg.d_model, h, **kw),
        "out_proj": linear_init(gen, cfg.d_inner, cfg.d_model, **kw),
        "conv_x": (_randn(gen, (k, cfg.d_inner), device) * 0.1).to(dtype),
        "conv_x_b": torch.zeros((cfg.d_inner,), dtype=dtype, device=device),
        "conv_bc": (_randn(gen, (k, cfg.d_bc), device) * 0.1).to(dtype),
        "conv_bc_b": torch.zeros((cfg.d_bc,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "d": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(cfg.d_inner, dtype, device),
    }


def _causal_conv(u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over time, then SiLU.  u (B, S, C), w (K, C)."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    w32 = w.float()
    out = sum(pad[:, i:i + S, :].float() * w32[i] for i in range(K))
    return F.silu(out + b.float()).to(u.dtype)


def _segsum(a: Tensor) -> Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j<k<=i} a[..., k] for
    i >= j, -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                chunk: int, init_state: Tensor | None = None
                ) -> tuple[Tensor, Tensor]:
    """SSD scan.  x (b, s, h, p); dt (b, s, h) > 0; A (h,) < 0; B, C (b, s,
    h, n) (already expanded from groups to heads); ``s`` a multiple of
    ``chunk``.  ``init_state`` (b, h, p, n) continues a previous scan.
    Returns (y (b, s, h, p) f32, final state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = (x.float() * dt[..., None]).reshape(b, nc, chunk, h, p)
    Bc = B.float().reshape(b, nc, chunk, h, n)
    Cc = C.float().reshape(b, nc, chunk, h, n)
    dA = (dt * A).reshape(b, nc, chunk, h).movedim(-1, 2)   # (b,nc,h,cs)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. within each chunk (the diagonal blocks)
    Lmat = torch.exp(_segsum(dA))                           # (b,nc,h,cs,cs)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Lmat
    Ydiag = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # 2. each chunk's end state
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)       # (b,nc,h,cs)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. the recurrence over chunks: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])                 # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)

    # 4. entering state -> output within each chunk
    out_decay = torch.exp(dA_cs)                            # (b,nc,h,cs)
    Yoff = torch.einsum("bclhn,bchpn,bchl->bclhp", Cc, prev_states,
                        out_decay)
    return (Ydiag + Yoff).reshape(b, s, h, p), carry


def _project(p: dict, x: Tensor, qspec: QSpec | None):
    with scope("z_proj"):
        z = linear_apply(p["z_proj"], x, qspec)
    with scope("x_proj"):
        xs = linear_apply(p["x_proj"], x, qspec)
    with scope("bc_proj"):
        bc = linear_apply(p["bc_proj"], x, qspec)
    with scope("dt_proj"):
        dt = linear_apply(p["dt_proj"], x, qspec)
    return z, xs, bc, dt


def _rank_heads(p: dict, cfg: SSMConfig, z: Tensor, xs: Tensor):
    """``(z, xs, group, h0)``: the projections as the rank computes with
    them, the model axis's group when the rank scans its own heads
    ``h0 ..`` (None: every head, on one device or with the block whole on
    every rank).  Channels that split a head are gathered whole."""
    group = parallel.model_group({k: p[k] for k in ("z_proj", "x_proj")})
    if group is None or xs.shape[-1] == cfg.d_inner:
        return z, xs, None, 0
    n = parallel.group_size(group)
    if cfg.n_heads % n:
        return (parallel.gather_from(z, group, -1, reduce_grad=False),
                parallel.gather_from(xs, group, -1, reduce_grad=False),
                None, 0)
    return z, xs, group, torch.distributed.get_rank(group) * (
        cfg.n_heads // n)


def _split_heads(cfg: SSMConfig, xs: Tensor, bc: Tensor, lead: tuple,
                 group=None, h0: int = 0):
    """x as heads (*lead, hl, p); B and C (*lead, hl, n), head ``i``
    reading group ``i // (h / g)`` (``repeat_interleave``, the JAX twin's
    ``jnp.repeat``): the heads ``h0 .. h0 + hl`` of the replicated B and
    C (with ``group``, the rank's)."""
    h, n, g = cfg.n_heads, cfg.d_state, cfg.n_groups
    hl = xs.shape[-1] // cfg.head_dim
    xh = xs.reshape(*lead, hl, cfg.head_dim)
    bcg = torch.repeat_interleave(bc.reshape(*lead, 2, g, n), h // g,
                                  dim=len(lead) + 1)
    bcg = parallel.rank_part(bcg, group, len(lead) + 1, h0, hl)
    return xh, bcg.select(len(lead), 0), bcg.select(len(lead), 1)


def _gated_out(p: dict, cfg: SSMConfig, y: Tensor, xh: Tensor, z: Tensor,
               x: Tensor, qspec: QSpec | None, group=None,
               h0: int = 0) -> Tensor:
    """``D`` skip, gated norm and out_proj of the scan's f32 output (the
    rank's heads ``h0 ..`` with ``group``)."""
    hl = xh.shape[-2]
    d = parallel.rank_part(p["d"], group, 0, h0, hl)
    y = y + xh.float() * d[:, None]
    y = y.reshape(*x.shape[:-1], hl * cfg.head_dim).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z.float()).to(x.dtype),
                      group=group, c0=h0 * cfg.head_dim, width=cfg.d_inner)
    with scope("out_proj"):
        return linear_apply(p["out_proj"], y, qspec)


def mamba_apply(p: dict, cfg: SSMConfig, x: Tensor, *,
                qspec: QSpec | None = None) -> Tensor:
    """Full-sequence forward (training / prefill).  x (B, S, D)."""
    B_, S, _ = x.shape
    z, xs, bc, dt = _project(p, x, qspec)
    xs = _causal_conv(xs, p["conv_x"], p["conv_x_b"])
    bc = _causal_conv(bc, p["conv_bc"], p["conv_bc_b"])
    z, xs, group, h0 = _rank_heads(p, cfg, z, xs)
    xh, Bm, Cm = _split_heads(cfg, xs, bc, (B_, S), group, h0)
    hl = xh.shape[-2]
    dt = F.softplus(parallel.rank_part(dt, group, -1, h0, hl).float()
                    + parallel.rank_part(p["dt_bias"], group, 0, h0, hl))
    A = -torch.exp(parallel.rank_part(p["a_log"], group, 0, h0, hl))
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, min(cfg.chunk, S))
    return _gated_out(p, cfg, y, xh, z, x, qspec, group, h0)


def mamba_init_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "conv_x": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_bc),
                               dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=dtype, device=device),
    }


def _conv_step(cache: Tensor, u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """One causal-conv step.  cache (B, K-1, C) is shifted by one row in
    place, u (B, C) entering last; returns silu(conv) in f32."""
    win = torch.cat([cache, u[:, None, :].to(cache.dtype)], dim=1)
    y = torch.einsum("bkc,kc->bc", win.float(), w.float())
    cache.copy_(win[:, 1:])
    return F.silu(y + b.float())


def mamba_decode(p: dict, cfg: SSMConfig, x: Tensor, cache: dict, *,
                 qspec: QSpec | None = None) -> tuple[Tensor, dict]:
    """Single-token recurrent step.  x (B, 1, D).

    The new conv windows and state are written into ``cache["conv_x"]``,
    ``cache["conv_bc"]`` and ``cache["state"]`` in place (the JAX twin
    returns updated copies), as ``attn_decode`` writes K/V: a step
    captured as a CUDA graph reads and writes the caches at fixed
    addresses.  Returns (out (B, 1, D), the same cache dict)."""
    B_ = x.shape[0]
    z, xs, bc, dt = _project(p, x, qspec)
    z, xs, bc, dt = z[:, 0], xs[:, 0], bc[:, 0], dt[:, 0]
    xs = _conv_step(cache["conv_x"], xs, p["conv_x"], p["conv_x_b"])
    bc = _conv_step(cache["conv_bc"], bc, p["conv_bc"], p["conv_bc_b"])
    z, xs, group, h0 = _rank_heads(p, cfg, z, xs)
    xh, Bm, Cm = _split_heads(cfg, xs, bc, (B_,), group, h0)
    hl = xh.shape[-2]
    dt_ = F.softplus(parallel.rank_part(dt, group, -1, h0, hl).float()
                     + parallel.rank_part(p["dt_bias"], group, 0, h0, hl))
    A = -torch.exp(parallel.rank_part(p["a_log"], group, 0, h0, hl))
    decay = torch.exp(dt_ * A)                              # (B, h)
    st = cache["state"]
    new = (st * decay[:, :, None, None]
           + torch.einsum("bh,bhn,bhp->bhpn", dt_, Bm, xh.float()))
    st.copy_(new)
    y = torch.einsum("bhn,bhpn->bhp", Cm, new)
    out = _gated_out(p, cfg, y, xh, z[:, None], x, qspec, group, h0)
    return out, cache
