"""Launcher of the padded CSR neighbour-table CUDA kernel.

The kernel (``csrc/lineage_gather.cu``) replaces the TPU kernel
``repro/kernels/lineage_gather.py::lineage_gather_kernel``; its note says
what bounds it on an H100 and what the design does about it: the grid
covers the ``Q x max_deg`` output, a warp owning ``32 x``
:data:`WORDS_PER_THREAD` consecutive row-major words, so every lane works
whatever ``max_deg`` is and each warp's loads and stores touch consecutive
words.  This module checks the operands, sizes the grid
(:func:`gather_geometry`) and launches on PyTorch's current stream.  It
never falls back: a tensor off the card, an unsuitable card or a failed
launch raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["THREADS", "WORDS_PER_THREAD", "GatherGeometry", "reciprocal", "gather_geometry",
           "lineage_gather_cuda"]

THREADS = 256            # kThreads
WORDS_PER_THREAD = 4     # kPer: output words a thread, 32 apart

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _P, _I, ctypes.c_uint, _I, _P, _P]


class GatherGeometry(NamedTuple):
    words: int       # Q * max_deg output words
    ctas: int        # grid (0: nothing launched)
    warps: int       # warps that own words, 32 x WORDS_PER_THREAD each (the last fewer)
    magic: int       # the reciprocal of max_deg: e // max_deg ==
    shift: int       #   (mulhi(magic, e) + e) >> shift for 0 <= e < 2^31


def reciprocal(d: int) -> tuple:
    """(magic, shift) with ``(((magic * e) >> 32) + e) >> shift == e // d``
    for every ``0 <= e < 2^31`` and ``1 <= d < 2^31`` (Granlund and
    Montgomery's round-up method; the sum stays below 2^32)."""
    shift = (d - 1).bit_length()                 # ceil(log2(d))
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def gather_geometry(q: int, max_deg: int) -> GatherGeometry:
    """The grid over a ``(q, max_deg)`` table: a warp per ``32 x``
    :data:`WORDS_PER_THREAD` consecutive row-major words."""
    if q < 0 or max_deg < 1:
        raise ValueError(f"lineage_gather needs Q >= 0 and max_deg >= 1, got {q}, {max_deg}")
    words = q * max_deg
    if words > (1 << 31) - 1 - THREADS * WORDS_PER_THREAD:
        raise ValueError(f"lineage_gather kernel takes fewer than 2^31 output words, got {words}")
    return GatherGeometry(words, -(-words // (THREADS * WORDS_PER_THREAD)),
                          -(-words // (32 * WORDS_PER_THREAD)), *reciprocal(max_deg))


def lineage_gather_cuda(queries: torch.Tensor, row_ptr: torch.Tensor,
                        col_idx: torch.Tensor, max_deg: int) -> torch.Tensor:
    """(Q, max_deg) int32 neighbour table of CUDA int32 ``queries`` (Q,)
    over the CSR ``row_ptr`` (R+1,) / ``col_idx``; -1 past each degree."""
    dev = build.check_operands("lineage_gather", (queries, row_ptr, col_idx), (1, 1, 1))
    q, r = queries.shape[0], row_ptr.shape[0] - 1
    geo = gather_geometry(q, max_deg)
    out = torch.empty((q, max_deg), dtype=torch.int32, device=dev)
    rc = build.launcher("lineage_gather", _ARGTYPES)(
        queries.data_ptr(), q, row_ptr.data_ptr(), r, col_idx.data_ptr(), max_deg,
        geo.magic, geo.shift, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("lineage_gather", rc)
    return out
