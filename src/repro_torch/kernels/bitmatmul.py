"""Launcher of the packed (OR, AND) matrix-product CUDA kernel.

The kernel (``csrc/bitmatmul.cu``) replaces the TPU kernel
``repro/kernels/bitmatmul.py::bitmatmul_kernel``; its note says what bounds
it on an H100 and what the design does about it.  This module checks the
operands and launches on PyTorch's current stream.  It never falls back:
an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["bitmatmul_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def bitmatmul_cuda(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """``C = A (OR, AND) B`` for CUDA int32 operands already checked for the
    contraction: A (M, Kw), B (K, Nw) -> C (M, Nw)."""
    dev = build.check_operands("bitmatmul", (a_bits, b_bits), (2, 2))
    m, kw = a_bits.shape
    k, nw = b_bits.shape
    out = torch.empty((m, nw), dtype=torch.int32, device=dev)
    rc = build.launcher("bitmatmul", _ARGTYPES)(
        a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(), m, kw, k, nw,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bitmatmul", rc)
    return out
