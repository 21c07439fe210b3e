"""Carry parameters of the JAX package into the port's tree.

The port keys its params by the same dot paths as the JAX tree
(``blocks.<i>.attn.q.qcodes`` eager, ``blocks.attn.q.qcodes`` with a
leading layer axis when scan-stacked), so the carry is a leaf-by-leaf
map; MoE trees carry their f32 router and their expert stacks ``(E, m,
n)`` (``(L, E, m, n)`` scan-stacked), packed expert leaves with their
leading ``E``; SSM blocks their f32 ``a_log``, ``d`` and ``dt_bias`` and
their ``conv_*`` leaves; a hybrid tree its ``shared.block`` and the
per-site ``shared.site_lora`` stacks ``(S, m, r)``, which are not
layer-stacked and carry unchanged in either layout; an enc-dec tree its
``enc_blocks``, ``dec_blocks`` and ``cross`` containers (each stacked or
per layer, as ``blocks``) and its ``enc_norm``.  The caller exports the JAX tree to numpy first (for example
``jax.tree.map(np.asarray, params)``); this module imports neither ``jax``
nor the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pipeline import (_STACK_KEYS, to_eager_params,
                                       to_scan_params)
from repro_torch.models.transformer import ModelConfig
from repro_torch.utils import resolve_device

Tensor = torch.Tensor


def _leaf(a, device) -> Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: same 16 bits as torch.bfloat16, so the bits
        # are carried unchanged
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, device):
    if isinstance(tree, dict):
        return {str(k): _map(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_jax(tree_of_numpy: dict, cfg: ModelConfig,
                    device: str | torch.device | None = None) -> dict:
    """Map a JAX param tree, exported as numpy, onto ``device``: CUDA
    unless the caller asks for another (``utils.resolve_device``; raises
    on a host without CUDA rather than build the model on the CPU).

    dtypes: every leaf keeps its dtype.  A bf16 leaf may come as an
    ``ml_dtypes`` bfloat16 array (what ``np.asarray`` of a JAX bf16 array
    gives); its bits are reinterpreted as ``torch.bfloat16``, exactly.  A
    leaf already widened to float32 by the caller stays float32.  The
    layout follows ``cfg.scan_layers``: scan-stacked containers are
    unstacked for an eager config and per-layer ones stacked for a scan
    config."""
    params = _map(tree_of_numpy, resolve_device(device))
    blocks = next((params[k] for k in _STACK_KEYS if k in params), {})
    eager = bool(blocks) and all(k.isdigit() for k in blocks)
    if cfg.scan_layers and eager:
        return to_scan_params(params, cfg)
    if not cfg.scan_layers and not eager:
        return to_eager_params(params, dataclasses.replace(cfg,
                                                           scan_layers=True))
    return params
