"""Dispatch wrappers called from model code.

The device decides: a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the hand-written
kernel, for every shape, or the wrapper raises.  Nothing falls back from a
CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import dequant_matmul as _dqmm
from repro_torch.kernels import flash_attention as _flash

Tensor = torch.Tensor

KERNELS = {"dequant_matmul": _dqmm, "flash_attention": _flash}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _plain(t: Tensor) -> bool:
    if build.is_cuda(t):
        return False
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return True


def dequant_matmul(x: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
                   *, bits: int, group_size: int | None) -> Tensor:
    if _plain(x):
        return ref.dequant_matmul_ref(x, packed, scales, zeros, bits=bits,
                                      group_size=group_size)
    return _dqmm.dequant_matmul_cuda(x, packed, scales, zeros, bits=bits,
                                     group_size=group_size)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    lengths: Tensor | None = None) -> Tensor:
    if _plain(q):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       lengths=lengths)
    return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                       lengths=lengths)
