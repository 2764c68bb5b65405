"""Launcher of the batched bitset-rank CUDA kernel.

The kernel (``csrc/bitset_rank.cu``) replaces the TPU kernel
``repro/kernels/bitset_rank.py::bitset_rank_kernel``; its note says what
bounds it on an H100 and what the design does about it.  This module checks
the operands and launches on PyTorch's current stream.  It never falls back:
an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["bitset_rank_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _P, _P]


def bitset_rank_cuda(words: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Inclusive ranks (Q,) int32 of CUDA int32 ``positions`` (Q,) in the
    packed bitset ``words`` (W,)."""
    dev = build.check_operands("bitset_rank", (words, positions), (1, 1))
    w, q = words.shape[0], positions.shape[0]
    if 32 * w >= 1 << 31:
        raise ValueError(f"bitset_rank kernel takes at most 2^31 bits, got {32 * w}")
    out = torch.empty(q, dtype=torch.int32, device=dev)
    rc = build.launcher("bitset_rank", _ARGTYPES)(
        words.data_ptr(), w, positions.data_ptr(), q, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bitset_rank", rc)
    return out
