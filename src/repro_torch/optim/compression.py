"""Gradient compression: int8 quantization with error feedback for the
data-parallel gradient reduction.  Twin of ``repro.optim.compression``.

Each rank quantizes (grad + residual) to int8 with one f32 scale a leaf
shared by the ranks (an all-reduce MAX of their scales, so that the summed
codes dequantize exactly), the codes are summed over the data group and
the quantization error is carried to the next step (Seide et al. 2014,
EF-SGD).  The twin sums int16 codes; NCCL has no int16 and gloo is not
relied on for it, so the codes are summed as int32 here.  The sums are
exact integers either way (at most 127 x ranks in magnitude), so the
synced gradients are the twin's numbers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import parallel
from repro_torch.optim.adamw import tree_map

Tensor = torch.Tensor


def compress_int8(g: Tensor) -> tuple[Tensor, Tensor]:
    """(int8 codes, f32 scale), the scale chosen so that max|g| -> 127."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor,
                    dtype=torch.float32) -> Tensor:
    return (q.float() * scale).to(dtype)


def ef_psum_int8(grads, residuals, group):
    """Error-feedback compressed mean over ``group`` (a process group; the
    twin's ``axis_names`` inside a ``shard_map``).

    grads/residuals: same-structured trees of the rank's tensors.  Returns
    (synced f32 grads, the mean over the group's ranks; new residuals).
    Two collectives a leaf: the scale's MAX and the codes' sum."""
    n = parallel.group_size(group)

    def one(g, r):
        g32 = g.float() + r
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        smax = parallel.all_reduce_sum(scale.reshape(1).clone(), group,
                                       op=dist.ReduceOp.MAX)[0]
        q = torch.clamp(torch.round(g32 / smax), -127, 127).to(torch.int8)
        new_r = g32 - q.float() * smax
        summed = parallel.all_reduce_sum(q.to(torch.int32), group)
        return summed.float() * smax / n, new_r

    outs = tree_map(one, grads, residuals)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    return pick(outs, 0), pick(outs, 1)
