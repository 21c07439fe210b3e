"""Model stack: config, init, forward, loss and cached decode.

PyTorch twin of ``repro.models.transformer``: the dense, MoE, SSM, hybrid
and enc-dec families, and the vision prefix.  Block params are either
scan-stacked (every leaf under ``blocks`` has a leading layer axis, as the
JAX package stacks them for ``lax.scan``; MoE expert stacks are ``(L, E,
m, n)``) or eager (``blocks.<i>.…``); the layer loop is a Python loop over
either layout.

A hybrid (Zamba2-style) model adds ``shared``: one attention + MLP block
(``shared.block``) applied after every ``hybrid_attn_every`` Mamba layers,
each application (a site) with its own LoRA pair spliced into every linear
from the stacks ``shared.site_lora.<mod>_<lin>.lora_a (S, m, r)`` and
``lora_b (S, n, r)``.  In the eager layout a site runs under the scope
``sites.<s>``, so its calibration Grams are keyed ``sites.<s>.shared.
attn.q`` and so on, as in the JAX package.

An enc-dec (seamless-style) model holds ``enc_blocks`` (``n_enc_layers``
dense blocks with bidirectional attention, then ``enc_norm``),
``dec_blocks`` (``n_layers`` causal dense blocks) and ``cross`` (one
``ln`` and non-causal ``xattn`` a decoder layer), each stacked or eager.
The frontend is a stub: ``batch["enc_embeds"]`` is the encoder's input.
In training a decoder layer runs self-attention, MLP, then
cross-attention over the encoder output; in decode self-attention,
cross-attention over ``cache["enc_out"]``, then MLP: the JAX twin orders
them so in each, and the port keeps both.  Eager scopes are
``enc_blocks.<i>`` and ``dec_blocks.<i>`` (its cross-attention under
``dec_blocks.<i>.cross``), so calibration Grams carry the JAX keys.  A
vision-prefix model (``frontend="vision"``) prepends
``batch["prefix_embeds"]`` to the token embeddings and drops those
positions after the final norm.

Under a mesh (``pctx.mesh``, every family and the vision prefix) the
params are DTensors or tagged local shards (``models.parallel``) and
``batch``/``tokens`` hold the rank's data rows.  Tensor parallelism lives
in the linears, attention (and cross-attention), the Mamba block,
embedding and head (``modules``, ``attention``, ``ssm``), expert
parallelism in ``moe``; ``seq_shard`` keeps the residual stream between
sub-layers sharded along S over "model" (gathered before each sub-layer's
column linears, reduce-scattered after its row ones; a vision model's
prefix positions with the tokens'); the enc-dec encoder and its output,
the cross-attention's keys and values, stay whole along their sequence.
``loss_fn`` reduces the vocab-parallel log-likelihoods and the label
count over the data axes, so the loss is the global one on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.models.attention import (AttnConfig, attn_apply,
                                          attn_decode, attn_init,
                                          cross_attn_apply)
from repro_torch.models.mlp import swiglu_apply, swiglu_init
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init
from repro_torch.models import parallel
from repro_torch.models.modules import (QSpec, embedding_apply,
                                        embedding_init, head_vocab_shard,
                                        linear_init, lm_head_apply,
                                        rmsnorm_apply, rmsnorm_init,
                                        vocab_parallel_ll)
from repro_torch.models.parallel import LOCAL, PContext
from repro_torch.models.ssm import (SSMConfig, mamba_apply, mamba_decode,
                                    mamba_init)
from repro_torch.utils import (checkpoint, is_capturing, resolve_device,
                               scope)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int | None = None
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # hybrid (zamba2-style): shared attn+mlp block applied every k SSM layers
    hybrid_attn_every: int = 6
    hybrid_window: int | None = 4096   # sliding window of the decode ring
    # enc-dec
    n_enc_layers: int = 0
    frontend: str | None = None   # "audio" | "vision" (stub embeddings input)
    n_prefix: int = 0             # vlm: number of patch positions
    vocab_pad_multiple: int = 1   # pad embedding/head rows
    quant: QSpec | None = None
    lora_rank: int = 0            # LoRA on dense weights
    scan_layers: bool = True
    remat: str = "full"           # full | dots | tp_out | none
    dtype: Any = torch.bfloat16
    loss_chunk: int = 0           # >0: CE loss computed over seq chunks
    attn_chunk: int = 0           # >0: blockwise query-chunked attention
    seq_shard: bool = False       # sequence-parallel residual stream (mesh)

    def attn_cfg(self, causal=True, window=None) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.head_dim, self.qk_norm, self.rope_theta,
                          window, causal, self.attn_bias)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.n_experts, self.top_k, self.d_model,
                         self.d_ff_expert, self.capacity_factor)

    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(self.d_model, self.ssm_state, self.ssm_head_dim,
                         2, self.ssm_groups, 4, self.ssm_chunk)

    @property
    def trainable_rank(self) -> int:
        return self.quant.rank if self.quant else self.lora_rank

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def n_hybrid_sites(self) -> int:
        return (self.n_layers // self.hybrid_attn_every
                if self.family == "hybrid" else 0)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raise for an unknown family."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; options "
                         f"{FAMILIES}")


def _block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    r = cfg.lora_rank
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": rmsnorm_init(cfg.d_model, cfg.dtype, device),
                "mamba": mamba_init(gen, cfg.ssm_cfg(), dtype=cfg.dtype,
                                    lora_rank=r, device=device)}
    p = {"ln1": rmsnorm_init(cfg.d_model, cfg.dtype, device),
         "attn": attn_init(gen, cfg.attn_cfg(), dtype=cfg.dtype,
                           lora_rank=r, device=device),
         "ln2": rmsnorm_init(cfg.d_model, cfg.dtype, device)}
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg.moe_cfg(), dtype=cfg.dtype,
                            lora_rank=r, device=device)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                               lora_rank=r, device=device)
    return p


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig,
                       device) -> dict:
    """The Zamba2-style shared block (no LoRA of its own) and its per-site
    LoRA stacks, rank ``max(trainable_rank, 8)``: ``lora_a`` (S, m, r)
    random, ``lora_b`` (S, n, r) zero."""
    blk = {"ln1": rmsnorm_init(cfg.d_model, cfg.dtype, device),
           "attn": attn_init(gen, cfg.attn_cfg(), dtype=cfg.dtype,
                             device=device),
           "ln2": rmsnorm_init(cfg.d_model, cfg.dtype, device),
           "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                              device=device)}
    r = max(cfg.trainable_rank, 8)
    S = cfg.n_hybrid_sites
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dims = {"attn.q": (cfg.d_model, q), "attn.k": (cfg.d_model, kv),
            "attn.v": (cfg.d_model, kv), "attn.o": (q, cfg.d_model),
            "mlp.gate": (cfg.d_model, cfg.d_ff),
            "mlp.up": (cfg.d_model, cfg.d_ff),
            "mlp.down": (cfg.d_ff, cfg.d_model)}
    lora = {}
    for path, (m, n) in sorted(dims.items()):
        lora[path.replace(".", "_")] = {
            "lora_a": (torch.randn((S, m, r), generator=gen,
                                   dtype=torch.float32, device=device)
                       / m ** 0.5).to(cfg.dtype),
            "lora_b": torch.zeros((S, n, r), dtype=cfg.dtype, device=device)}
    return {"block": blk, "site_lora": lora}


def _with_site_lora(shared: dict, site_lora: dict, site: int) -> dict:
    """The shared block with site ``site``'s LoRA spliced into each linear
    (views of the stacks, so gradients reach them; a local shard keeps its
    layout tag)."""
    blk = {"ln1": shared["ln1"], "ln2": shared["ln2"],
           "attn": dict(shared["attn"]), "mlp": dict(shared["mlp"])}
    for key, sub in site_lora.items():
        mod, lin = key.split("_", 1)
        blk[mod][lin] = dict(
            blk[mod][lin], lora_a=parallel.select_layer(sub["lora_a"], site),
            lora_b=parallel.select_layer(sub["lora_b"], site))
    return blk


def _direct(fn, *args):
    return fn(*args)


def _shared_block_apply(p: dict, cfg: ModelConfig, x: Tensor, site: int,
                        sub=_direct, sp=None) -> Tensor:
    """The shared block at site ``site``; ``sub`` runs each sub-layer (a
    checkpoint under ``remat="tp_out"``), ``sp`` the sequence-parallel
    group (:func:`_sublayer`)."""
    blk = _with_site_lora(p["block"], p["site_lora"], site)
    with scope("shared.attn"):
        x = x + sub(_sublayer(lambda h: attn_apply(
            blk["attn"], cfg.attn_cfg(), h, qspec=cfg.quant), blk["ln1"],
            sp), x)
    with scope("shared.mlp"):
        x = x + sub(_sublayer(lambda h: swiglu_apply(blk["mlp"], h,
                                                     cfg.quant),
                              blk["ln2"], sp), x)
    return x


def _site_after(cfg: ModelConfig, layer: int) -> int | None:
    """The shared-block site applied after layer ``layer``, or None."""
    every = cfg.hybrid_attn_every
    if cfg.family != "hybrid" or (layer + 1) % every:
        return None
    site = (layer + 1) // every - 1
    return site if site < cfg.n_hybrid_sites else None


def stack_layers(layers: list[dict]) -> dict:
    """Stack per-layer param dicts leaf by leaf (leading layer axis)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of stacked block params, as views (a local shard keeps
    its layout tag)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return parallel.select_layer(blocks, i)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """Random params with the JAX package's shapes, dtypes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA
    unless given).  The draws differ from ``jax.random``'s.  On the
    ``"meta"`` device the tree holds shapes and dtypes only: nothing is
    allocated or drawn (the generator, which the meta device cannot hold,
    stays on the CPU unused)."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    vp = cfg.vocab_padded
    p: dict = {"embed": embedding_init(gen, vp, cfg.d_model, cfg.dtype, dev),
               "final_norm": rmsnorm_init(cfg.d_model, cfg.dtype, dev)}
    if not cfg.tie_embeddings:
        p["head"] = linear_init(gen, cfg.d_model, vp, dtype=cfg.dtype,
                                device=dev)

    def make_stack(layers: list[dict]) -> dict:
        return (stack_layers(layers) if cfg.scan_layers
                else {str(i): l for i, l in enumerate(layers)})

    if cfg.family == "encdec":
        p["enc_blocks"] = make_stack([_block_init(gen, cfg, dev)
                                      for _ in range(cfg.n_enc_layers)])
        p["dec_blocks"] = make_stack([_block_init(gen, cfg, dev)
                                      for _ in range(cfg.n_layers)])
        p["cross"] = make_stack([
            {"ln": rmsnorm_init(cfg.d_model, cfg.dtype, dev),
             "xattn": attn_init(gen, cfg.attn_cfg(causal=False),
                                dtype=cfg.dtype, lora_rank=cfg.lora_rank,
                                device=dev)}
            for _ in range(cfg.n_layers)])
        p["enc_norm"] = rmsnorm_init(cfg.d_model, cfg.dtype, dev)
    else:
        p["blocks"] = make_stack([_block_init(gen, cfg, dev)
                                  for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        p["shared"] = _shared_block_init(gen, cfg, dev)
    return p


def _seq_group(cfg: ModelConfig, pctx: PContext):
    """The model axis's group when ``cfg.seq_shard`` shards the residual
    stream along S over it, else None."""
    if not cfg.seq_shard or pctx.mesh is None or \
            parallel.axis_size(pctx.mesh, pctx.model_axis) == 1:
        return None
    return parallel.axis_group(pctx.mesh, pctx.model_axis)


def _sublayer(fn, norm: dict, sp):
    """``h -> fn(rmsnorm(norm, h))``.  Under sequence parallelism (``sp``:
    the model axis's group) ``h`` is the rank's S slice: it is normalized
    there (the scale's gradient summed), gathered along S, run with the
    row-sharded linears reduce-scattering along S, and an output that comes
    back whole is sliced (what GSPMD does under the twin's
    ``_seq_shard``)."""
    if sp is None:
        return lambda h: fn(rmsnorm_apply(norm, h))

    def run(h):
        ln = {"scale": parallel.copy_to(norm["scale"], sp)}
        full = parallel.gather_from(rmsnorm_apply(ln, h), sp, 1,
                                    reduce_grad=False)
        with parallel.row_output(1):
            out = fn(full)
        y = out[0] if isinstance(out, tuple) else out
        if y.shape[1] != h.shape[1]:
            y = parallel.scatter_to(y, sp, 1)
        return (y, *out[1:]) if isinstance(out, tuple) else y
    return run


def _block_apply(p, cfg: ModelConfig, x: Tensor, pctx: PContext = LOCAL,
                 causal: bool = True,
                 sub=_direct) -> tuple[Tensor, Tensor | None]:
    """Returns (y, aux_loss): the MoE block's aux loss, None for the
    other families.  ``causal=False``: the enc-dec encoder's
    bidirectional attention (never query-chunked, as in the JAX twin's
    encoder, and never sequence-sharded: the encoder and its output stay
    whole along Se); otherwise ``cfg.attn_chunk`` chunks the queries.
    ``sub`` runs each sub-layer (a checkpoint under ``remat="tp_out"``)."""
    q = cfg.quant
    sp = _seq_group(cfg, pctx) if causal else None
    if cfg.family in ("ssm", "hybrid"):
        # under seq_shard the scan gathers the whole sequence
        with scope("mamba"):
            y = sub(_sublayer(lambda h: mamba_apply(
                p["mamba"], cfg.ssm_cfg(), h, qspec=q), p["norm"], sp), x)
        return x + y, None
    chunk = (cfg.attn_chunk or None) if causal else None
    with scope("attn"):
        x = x + sub(_sublayer(lambda h: attn_apply(
            p["attn"], cfg.attn_cfg(causal=causal), h, qspec=q,
            q_chunk=chunk), p["ln1"], sp), x)
    if cfg.family == "moe":
        with scope("moe"):
            y, aux = sub(_sublayer(lambda h: moe_apply(
                p["moe"], cfg.moe_cfg(), h, qspec=q, pctx=pctx),
                p["ln2"], sp), x)
        return x + y, aux
    with scope("mlp"):
        x = x + sub(_sublayer(lambda h: swiglu_apply(p["mlp"], h, q),
                              p["ln2"], sp), x)
    return x, None


def _ffn_decode(bp: dict, cfg: ModelConfig, h: Tensor,
                pctx: PContext) -> Tensor:
    if cfg.family == "moe":
        return moe_apply(bp["moe"], cfg.moe_cfg(), h, qspec=cfg.quant,
                         pctx=pctx)[0]
    return swiglu_apply(bp["mlp"], h, cfg.quant)


def n_stacked(blocks: dict) -> int:
    """Layer count of stacked block params (their leading axis)."""
    while isinstance(blocks, dict):
        blocks = next(iter(blocks.values()))
    return blocks.shape[0]


def _layers(blocks: dict, cfg: ModelConfig):
    """(name, params) of each layer in order, for either layout."""
    if cfg.scan_layers:
        return [(str(i), layer_params(blocks, i))
                for i in range(n_stacked(blocks))]
    return [(i, blocks[i]) for i in sorted(blocks, key=int)]


def _layer_scope(cfg: ModelConfig, name: str):
    """The eager layout's per-layer scope (calibration keys); none for a
    scan-stacked model, as under the JAX twin's ``lax.scan``."""
    return contextlib.nullcontext() if cfg.scan_layers else scope(name)


# ---------------------------------------------------------------------------
# Activation recompute: the ``remat`` lever (the JAX twin's _remat_policy).
# ---------------------------------------------------------------------------


def _dots_ops() -> list:
    """The ops whose outputs ``remat="dots"`` keeps: the matrix products,
    aten's and the quantized linears' (``kernels.ops`` registers them as
    custom ops, so that the selective checkpoint sees them)."""
    from repro_torch.kernels import ops  # noqa: F401  (registers them)
    aten = torch.ops.aten
    return [aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default, torch.ops.repro_torch.dequant_matmul.default,
            torch.ops.repro_torch.dequant_matmul_lora.default]


def _remat_mode(cfg: ModelConfig, force: bool = False) -> str | None:
    """The recompute policy a training forward runs under: None for
    ``"none"`` (``"full"`` with ``force``: the stacked enc-dec layout's
    rule, as in the JAX twin) and while calibration Grams are captured;
    ``"dots"`` or ``"tp_out"``; ``"full"`` for any other string."""
    if is_capturing():
        return None
    if cfg.remat == "none":
        return "full" if force else None
    return cfg.remat if cfg.remat in ("dots", "tp_out") else "full"


def _runners(mode: str | None):
    """(unit, sub) under ``mode``: how a block-level region (a block, a
    shared-block site, an enc-dec decoder layer) and a sub-layer (an
    attention, MLP, MoE or Mamba step) are run.  ``"full"`` checkpoints
    each unit (nothing inside is kept), ``"dots"`` each unit keeping its
    matrix products' outputs, ``"tp_out"`` each sub-layer (its output is
    kept, its inside recomputed)."""
    if mode == "full":
        return checkpoint, _direct
    if mode == "dots":
        return (lambda fn, *a: checkpoint(fn, *a, save_ops=_dots_ops()),
                _direct)
    if mode == "tp_out":
        return _direct, checkpoint
    return _direct, _direct


def _encode(params: dict, cfg: ModelConfig, enc_embeds: Tensor,
            unit=_direct, sub=_direct, pctx: PContext = LOCAL) -> Tensor:
    """The enc-dec encoder: bidirectional dense blocks over the frontend
    stub's embeddings (B, Se, D), then ``enc_norm``.  Returns enc_out
    (whole along Se on every rank under a mesh).  ``unit``/``sub``:
    :func:`_runners`."""
    x = enc_embeds.to(cfg.dtype)
    for i, bp in _layers(params["enc_blocks"], cfg):
        with _layer_scope(cfg, f"enc_blocks.{i}"):
            x, _ = unit(lambda h, bp=bp: _block_apply(bp, cfg, h, pctx,
                                                      causal=False, sub=sub),
                        x)
    return rmsnorm_apply(params["enc_norm"], x)


def encode(params: dict, cfg: ModelConfig, enc_embeds: Tensor, *,
           pctx: PContext = LOCAL) -> Tensor:
    """An enc-dec model's encoder output ``(B, Se, D)`` for the frontend
    stub's embeddings, what ``init_decode_cache``'s ``enc_out`` is filled
    with.  Under a mesh ``enc_embeds`` are the rank's data rows."""
    if pctx.mesh is not None:
        params = parallel.localize(params)
    return _encode(params, cfg, enc_embeds, pctx=pctx)


def _cross_apply(cp: dict, cfg: ModelConfig, x: Tensor, enc_out: Tensor,
                 sub=_direct, sp=None) -> Tensor:
    """A decoder layer's residual cross-attention over ``enc_out``; ``sp``:
    :func:`_sublayer`'s (the queries' S sharded, ``enc_out`` whole)."""
    with scope("cross"):
        return x + sub(_sublayer(lambda h: cross_attn_apply(
            cp["xattn"], cfg.attn_cfg(causal=False), h, enc_out,
            qspec=cfg.quant), cp["ln"], sp), x)


def _forward_encdec(params: dict, cfg: ModelConfig, batch: dict,
                    pctx: PContext = LOCAL) -> Tensor:
    """The enc-dec decoder's hidden states before the final norm: each
    layer's dense block (attention, MLP), then its cross-attention.  In the
    stacked layout every encoder block and decoder layer is checkpointed
    (``remat="none"`` counts as ``"full"`` there), in the eager one none
    is, as in the JAX twin.  Under ``seq_shard`` the decoder's residual
    stream is sharded along S (returned so)."""
    unit, sub = _runners(_remat_mode(cfg, force=True) if cfg.scan_layers
                         else None)
    enc_out = _encode(params, cfg, batch["enc_embeds"], unit, sub, pctx)
    x = embedding_apply(params["embed"], batch["tokens"]).to(cfg.dtype)
    sp = _seq_group(cfg, pctx)
    if sp is not None:
        x = parallel.scatter_to(x, sp, 1)
    cross = dict(_layers(params["cross"], cfg))

    def layer(bp, cp, h):
        h, _ = _block_apply(bp, cfg, h, pctx, sub=sub)
        return _cross_apply(cp, cfg, h, enc_out, sub, sp)

    for i, bp in _layers(params["dec_blocks"], cfg):
        with _layer_scope(cfg, f"dec_blocks.{i}"):
            x = unit(lambda h, bp=bp, cp=cross[i]: layer(bp, cp, h), x)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            pctx: PContext = LOCAL, return_hidden: bool = False):
    """Training/prefill forward.  batch: tokens (B, S) int; an enc-dec
    model's ``enc_embeds`` (B, Se, D); a vision model's optional
    ``prefix_embeds`` (B, P, D), prepended to the token embeddings.
    Returns (logits (B, S, V), aux) — or (hidden (B, S, D), aux) with
    ``return_hidden``: text positions only.  ``aux`` is the f32 sum of the
    MoE layers' load balance losses (zero for the other families)."""
    check_family(cfg)
    if pctx.mesh is not None:
        params = parallel.localize(params)
    if cfg.family == "encdec":
        x = _forward_encdec(params, cfg, batch, pctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _forward_blocks(params, cfg, batch, pctx)
    sp = _seq_group(cfg, pctx)
    if sp is None:
        x = rmsnorm_apply(params["final_norm"], x)
    else:
        ln = {"scale": parallel.copy_to(params["final_norm"]["scale"], sp)}
        x = parallel.gather_from(rmsnorm_apply(ln, x), sp, 1,
                                 reduce_grad=False)
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        x = x[:, batch["prefix_embeds"].shape[1]:, :]
    if return_hidden:
        return x, aux
    head = params.get("head", params["embed"])
    return _whole_vocab(head, lm_head_apply(head, x)), aux


def _whole_vocab(head: dict, logits: Tensor) -> Tensor:
    """Logits over the whole vocab: a vocab-sharded head's gathered."""
    shard = head_vocab_shard(head)
    if shard is None:
        return logits
    return parallel.gather_from(logits, shard[0], -1, reduce_grad=False)


def _forward_blocks(params: dict, cfg: ModelConfig, batch: dict,
                    pctx: PContext) -> tuple[Tensor, Tensor]:
    """The ``blocks`` stack (and a hybrid's shared-block sites) over the
    token embeddings, a vision model's prefix first.  Returns (hidden
    before the final norm, aux).

    Under ``cfg.remat`` each block is checkpointed (:func:`_runners`); in
    the stacked layout a hybrid's sites are too, and under ``"full"`` each
    segment of ``hybrid_attn_every`` blocks with its site is checkpointed
    around its checkpointed blocks (the JAX twin's ``seg_body``); the
    eager layout's sites are not (as in the JAX twin)."""
    x = embedding_apply(params["embed"], batch["tokens"]).to(cfg.dtype)
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(cfg.dtype), x], dim=1)
    sp = _seq_group(cfg, pctx)
    if sp is not None:
        x = parallel.scatter_to(x, sp, 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    mode = _remat_mode(cfg)
    unit, sub = _runners(mode)
    layers = _layers(params["blocks"], cfg)

    def block(i, bp, h):
        with _layer_scope(cfg, f"blocks.{i}"):
            return unit(lambda g: _block_apply(bp, cfg, g, pctx, sub=sub), h)

    def site_of(s, h):
        if not cfg.scan_layers:
            with scope(f"sites.{s}"):
                return _shared_block_apply(shared, cfg, h, s, sp=sp)
        return unit(lambda g: _shared_block_apply(shared, cfg, g, s, sub,
                                                  sp), h)

    if shared is not None and cfg.scan_layers and mode == "full":
        every = cfg.hybrid_attn_every
        for s in range(cfg.n_hybrid_sites):
            def segment(h, seg=layers[s * every:(s + 1) * every], s=s):
                for i, bp in seg:
                    h, _ = block(i, bp, h)
                return _shared_block_apply(shared, cfg, h, s, sp=sp)
            x = checkpoint(segment, x)
        layers = layers[cfg.n_hybrid_sites * every:]
    for i, bp in layers:
        x, a = block(i, bp, x)
        if a is not None:
            aux = aux + a
        site = _site_after(cfg, int(i))
        if site is not None:
            x = site_of(site, x)
    return x, aux


def _ce(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(sum of log-likelihoods over labels >= 0, count of such labels)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (ll * mask).sum(), mask.sum()


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            pctx: PContext = LOCAL) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """Mean next-token cross-entropy.  Returns (loss + 0.01 * aux,
    (loss, aux)), as the JAX twin.  With ``cfg.loss_chunk`` = C, where C
    divides the sequence length S and S > C, the head and log-softmax run
    over sequence chunks of C and the full (B, S, V) f32 logits never
    exist.  Under a mesh ``batch`` holds the rank's data rows; the loss is
    ``-sum(ll) / max(count, 1)`` over the global batch on every rank (sum
    and count all-reduced over the data axes, as under GSPMD), the
    log-likelihoods vocab-parallel when the head's vocab is sharded."""
    check_family(cfg)
    if pctx.mesh is not None:
        params = parallel.localize(params)
    labels = batch["labels"]
    C = cfg.loss_chunk
    chunked = bool(C and labels.shape[1] % C == 0 and labels.shape[1] > C)
    if pctx.mesh is None and not chunked:
        logits, aux = forward(params, cfg, batch, pctx=pctx)
        s, c = _ce(logits, labels)
        loss = -s / torch.clamp(c, min=1.0)
        return loss + 0.01 * aux, (loss, aux)
    hidden, aux = forward(params, cfg, batch, pctx=pctx, return_hidden=True)
    head = params.get("head", params["embed"])
    shard = head_vocab_shard(head)
    C = C if chunked else labels.shape[1]
    tot_s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tot_c = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hidden.shape[1] // C):
        logits = lm_head_apply(head, hidden[:, i * C:(i + 1) * C])
        lab = labels[:, i * C:(i + 1) * C]
        if shard is None:
            s, c = _ce(logits, lab)
        else:
            mask = (lab >= 0).float()
            s = (vocab_parallel_ll(logits, lab, shard) * mask).sum()
            c = mask.sum()
        tot_s = tot_s + s
        tot_c = tot_c + c
    if pctx.mesh is not None:
        tot = torch.stack([tot_s, tot_c])
        for ax in parallel.data_axis_tuple(pctx):
            tot = parallel.reduce_from(tot, parallel.axis_group(pctx.mesh,
                                                                ax))
        tot_s, tot_c = tot[0], tot[1]
    loss = -tot_s / torch.clamp(tot_c, min=1.0)
    return loss + 0.01 * aux, (loss, aux)


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device: str | torch.device | None = None,
                      pctx: PContext = LOCAL) -> dict:
    """Caches for one-token-at-a-time decode with context ``cache_len``:
    K/V ``(L, batch, cache_len, Hkv, hd)`` for dense and MoE, and for
    enc-dec with ``enc_out`` ``(batch, cache_len, d_model)`` (zeros until
    the caller fills it with an encoder output); f32 conv windows and SSM
    states (a leading layer axis) for SSM; for hybrid also ``shared_kv``,
    one K/V ring a site of ``min(cache_len, hybrid_window)`` positions.
    Under ``pctx.mesh`` the caches are DTensors laid out by
    ``launch.shardings.cache_specs`` (batch over the data axes, KV heads,
    SSM state heads and ``conv_x`` channels over "model" where it divides
    them, else a KV cache's sequence), each rank allocating only its
    block; ``idx`` stays a plain tensor."""
    check_family(cfg)
    if pctx.mesh is not None:
        return _sharded_cache(cfg, batch, cache_len, dtype, device, pctx)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    hd = cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1))
    idx = torch.zeros((), dtype=torch.int32, device=dev)

    def kv(n: int, length: int) -> dict:
        shape = (n, batch, length, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "idx": idx.clone()}

    if cfg.family in ("dense", "moe"):
        return kv(cfg.n_layers, cache_len)
    if cfg.family == "encdec":
        return {"enc_out": torch.zeros((batch, cache_len, cfg.d_model),
                                       dtype=dtype, device=dev),
                **kv(cfg.n_layers, cache_len)}
    s, L, f32 = cfg.ssm_cfg(), cfg.n_layers, torch.float32
    cache = {"conv_x": torch.zeros((L, batch, s.conv_kernel - 1, s.d_inner),
                                   dtype=f32, device=dev),
             "conv_bc": torch.zeros((L, batch, s.conv_kernel - 1, s.d_bc),
                                    dtype=f32, device=dev),
             "state": torch.zeros((L, batch, s.n_heads, s.head_dim,
                                   s.d_state), dtype=f32, device=dev),
             "idx": idx}
    if cfg.family == "hybrid":
        cache["shared_kv"] = kv(cfg.n_hybrid_sites,
                                min(cache_len, cfg.hybrid_window or cache_len))
    return cache


def _ssm_decode(params: dict, cfg: ModelConfig, cache: dict, x: Tensor,
                idx: Tensor) -> Tensor:
    """The SSM / hybrid layers of one decode step; conv windows, states and
    the shared block's K/V rings written in place."""
    q, scfg = cfg.quant, cfg.ssm_cfg()
    shared = params.get("shared")
    acfg = cfg.attn_cfg(window=cfg.hybrid_window)
    for i, bp in _layers(params["blocks"], cfg):
        li = int(i)
        y, _ = mamba_decode(bp["mamba"], scfg, rmsnorm_apply(bp["norm"], x),
                            {"conv_x": cache["conv_x"][li],
                             "conv_bc": cache["conv_bc"][li],
                             "state": cache["state"][li]}, qspec=q)
        x = x + y
        site = _site_after(cfg, li)
        if site is None:
            continue
        blk = _with_site_lora(shared["block"], shared["site_lora"], site)
        skv = cache["shared_kv"]
        y, _ = attn_decode(blk["attn"], acfg, rmsnorm_apply(blk["ln1"], x),
                           {"k": parallel.select_layer(skv["k"], site),
                            "v": parallel.select_layer(skv["v"], site),
                            "idx": idx}, qspec=q)
        x = x + y
        x = x + swiglu_apply(blk["mlp"], rmsnorm_apply(blk["ln2"], x), q)
    return x


def _sharded_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device, pctx: PContext) -> dict:
    from repro_torch.launch.shardings import cache_specs
    shapes = init_decode_cache(cfg, batch, cache_len, dtype, "meta")
    specs = cache_specs(cfg, shapes, pctx.mesh, pctx.data_axes)
    dev = resolve_device(device)

    def alloc(leaf, spec):
        if isinstance(leaf, dict):     # a hybrid's shared_kv
            return {k: alloc(v, spec[k]) for k, v in leaf.items()}
        if leaf.dim() == 0:
            return torch.zeros((), dtype=leaf.dtype, device=dev)
        shape = [n // parallel.entry_size(pctx.mesh, ax)
                 for n, ax in zip(leaf.shape, spec)]
        return parallel.distribute_local(
            torch.zeros(shape, dtype=leaf.dtype, device=dev), spec,
            pctx.mesh)
    return alloc(shapes, specs)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: Tensor,
                *, pctx: PContext = LOCAL) -> tuple[Tensor, dict]:
    """One decode step.  tokens (B, 1) int.  Returns (logits (B, V), cache).

    The new K/V rows, conv windows and SSM states are written into the
    cache's tensors in place (see ``attn_decode`` and ``mamba_decode``);
    the returned cache holds the same tensors and ``idx + 1``.  An enc-dec
    layer runs self-attention, cross-attention over ``cache["enc_out"]``
    (its K/V projected from all of it every step, as in the JAX twin),
    then the MLP.  Under a mesh ``tokens`` are the rank's rows of the
    cache's batch, the cache a :func:`init_decode_cache` ``(pctx=)`` one,
    and the logits its rows' over the whole vocab.  A cache sharded along
    the sequence (``cache_specs``' layout where the model axis does not
    divide the KV heads) decodes by a distributed softmax over the ranks'
    keys (``attention._decode_seq_sharded``): each layer's cache keeps its
    layout tag (``parallel.select_layer``)."""
    check_family(cfg)
    full = cache
    if pctx.mesh is not None:
        params, cache = parallel.localize(params), parallel.localize(cache)
    x = embedding_apply(params["embed"], tokens).to(cfg.dtype)
    q = cfg.quant
    idx = cache["idx"]
    if cfg.family in ("ssm", "hybrid"):
        x = _ssm_decode(params, cfg, cache, x, idx)
    else:
        acfg = cfg.attn_cfg()
        encdec = cfg.family == "encdec"
        blocks = params["dec_blocks" if encdec else "blocks"]
        cross = dict(_layers(params["cross"], cfg)) if encdec else None
        for i, bp in _layers(blocks, cfg):
            li = int(i)
            h = rmsnorm_apply(bp["ln1"], x)
            kv = {n: parallel.select_layer(cache[n], li) for n in "kv"}
            y, _ = attn_decode(bp["attn"], acfg, h, dict(kv, idx=idx),
                               qspec=q)
            x = x + y
            if encdec:
                x = _cross_apply(cross[i], cfg, x, cache["enc_out"])
            x = x + _ffn_decode(bp, cfg, rmsnorm_apply(bp["ln2"], x), pctx)
    x = rmsnorm_apply(params["final_norm"], x)
    head = params.get("head", params["embed"])
    logits = _whole_vocab(head, lm_head_apply(head, x))[:, 0, :]
    return logits, dict(full, idx=idx + 1)
