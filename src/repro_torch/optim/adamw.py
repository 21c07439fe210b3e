"""AdamW with trainable-subset masking (LoRA-only fine-tuning).

PyTorch twin of ``repro.optim.adamw``.  Param trees are nested dicts of
tensors.  ``partition_params`` splits a tree into (trainable, frozen) trees
of the same structure, with a ``(0,)`` f32 placeholder where a leaf lives
in the other tree, so gradients and Adam moments exist only for trainable
leaves.  Updates are functional (new tensors), as in the JAX twin.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils import set_path, tree_paths

Tensor = torch.Tensor

TRAINABLE_SUFFIXES = {
    "lora": ("lora_a", "lora_b"),
    "lora+norm": ("lora_a", "lora_b", "scale", "bias"),
}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"          # const | linear | cosine | wsd
    warmup_frac: float = 0.03
    total_steps: int = 1000
    trainable: str = "lora"           # lora | lora+norm | all
    microbatch: int = 1               # gradient-accumulation splits


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the key order of the dicts (the order ``tree_map`` uses)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _is_float(x) -> bool:
    return isinstance(x, Tensor) and x.is_floating_point()


def trainable_mask(params, mode: str = "lora"):
    """Nested dict of bools: which leaves train."""
    flat = tree_paths(params)
    if mode == "all":
        decision = {p: _is_float(v) for p, v in flat.items()}
    else:
        sfx = TRAINABLE_SUFFIXES[mode]
        decision = {}
        for p, v in flat.items():
            leafname = p.rsplit(".", 1)[-1]
            tagged = any(seg in ("lora_a", "lora_b") for seg in p.split("."))
            decision[p] = _is_float(v) and (leafname in sfx or
                                            (tagged and mode.startswith("lora")))
    out: dict = {}
    for p, d in decision.items():
        set_path(out, p, d)
    return out


def _empty_like(x) -> Tensor:
    # always a (0,) f32 placeholder; merge_params selects by shape
    return torch.zeros((0,), dtype=torch.float32, device=x.device)


def partition_params(params, mask):
    """(trainable, frozen) trees, same structure, ``(0,)`` placeholders."""
    train = tree_map(lambda p, m: p if m else _empty_like(p), params, mask)
    frozen = tree_map(lambda p, m: _empty_like(p) if m else p, params, mask)
    return train, frozen


def merge_params(train, frozen):
    # a leaf is the placeholder iff it is exactly the (0,) stub — a genuine
    # zero-size param (e.g. a rank-0 LoRA adapter from a bit-allocation
    # recipe, shape (m, 0)) keeps its own multi-dim shape and must win
    def pick(t, f):
        if t.numel():
            return t
        return f if tuple(t.shape) == (0,) else t
    return tree_map(pick, train, frozen)


def clip_by_global_norm(grads, max_norm: float, *, group=None,
                        sharded=None):
    """(grads scaled so their global f32 norm is at most ``max_norm``,
    the norm before scaling).  Over a mesh, ``sharded`` (a same-structured
    tree of bools) marks the leaves that are the rank's shard of a leaf
    sharded over ``group``: their squares are summed over the group (one
    all-reduce), every other leaf's counted once."""
    leaves = tree_leaves(grads)
    dev = leaves[0].device if leaves else torch.device("cpu")
    marks = (tree_leaves(sharded) if sharded is not None
             else [False] * len(leaves))
    sq = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(2)]
    for g, m in zip(leaves, marks):
        sq[bool(m)] = sq[bool(m)] + g.float().square().sum().to(dev)
    if group is not None and any(marks):
        from repro_torch.models.parallel import all_reduce_sum
        sq[1] = all_reduce_sum(sq[1].reshape(1), group)[0]
    gn = torch.sqrt(sq[0] + sq[1])
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_init(train_params):
    """Moments in f32 whatever the param dtype (master-precision states)."""
    leaves = tree_leaves(train_params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(f32, train_params),
            "nu": tree_map(f32, train_params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, opt_state, train_params, cfg: OptConfig,
                 schedule: Callable | None = None, *, group=None,
                 sharded=None):
    """One AdamW step on the trainable tree.  Returns (new_params,
    new_state, metrics); the lr is ``schedule(step + 1)``.  ``group``,
    ``sharded``: the clip's norm over sharded leaves
    (:func:`clip_by_global_norm`); the update is elementwise on each
    rank's shards."""
    step = opt_state["step"] + 1
    lr = schedule(step) if schedule is not None else cfg.lr
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, group=group,
                                       sharded=sharded)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        if p.numel() == 0:
            return p, mu, nu
        g32 = g.float()
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * g32.square()
        mhat = mu / bc1
        vhat = nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (delta + cfg.weight_decay * p32)
        return p32.to(p.dtype), mu, nu

    out = tree_map(upd, train_params, grads, opt_state["mu"],
                   opt_state["nu"])

    def unzip(tree, i):
        if isinstance(tree, dict):
            return {k: unzip(v, i) for k, v in tree.items()}
        return tree[i]

    new_state = {"mu": unzip(out, 1), "nu": unzip(out, 2), "step": step}
    return unzip(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}
