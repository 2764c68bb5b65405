"""Launcher of the padded CSR neighbour-table CUDA kernel.

The kernel (``csrc/lineage_gather.cu``) replaces the TPU kernel
``repro/kernels/lineage_gather.py::lineage_gather_kernel``; its note says
what bounds it on an H100 and what the design does about it.  This module
checks the operands and launches on PyTorch's current stream.  It never
falls back: an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["lineage_gather_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _P, _I, _P, _P]


def lineage_gather_cuda(queries: torch.Tensor, row_ptr: torch.Tensor,
                        col_idx: torch.Tensor, max_deg: int) -> torch.Tensor:
    """(Q, max_deg) int32 neighbour table of CUDA int32 ``queries`` (Q,)
    over the CSR ``row_ptr`` (R+1,) / ``col_idx``; -1 past each degree."""
    dev = build.check_operands("lineage_gather", (queries, row_ptr, col_idx), (1, 1, 1))
    if max_deg < 1:
        raise ValueError(f"lineage_gather kernel needs max_deg >= 1, got {max_deg}")
    q, r = queries.shape[0], row_ptr.shape[0] - 1
    out = torch.empty((q, max_deg), dtype=torch.int32, device=dev)
    rc = build.launcher("lineage_gather", _ARGTYPES)(
        queries.data_ptr(), q, row_ptr.data_ptr(), r, col_idx.data_ptr(), max_deg,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("lineage_gather", rc)
    return out
