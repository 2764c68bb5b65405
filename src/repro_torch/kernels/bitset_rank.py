"""Launcher of the batched bitset-rank CUDA kernel.

The kernel (``csrc/bitset_rank.cu``) replaces the TPU kernel
``repro/kernels/bitset_rank.py::bitset_rank_kernel``; its note says what
bounds it on an H100 and what the design does about it: a grid of tiles
(:data:`TILE_WORDS` words each) writes tile totals and per-line prefixes,
then a second launch scans the tile totals in shared memory and answers
each query from its tile's prefix, its line's prefix and one 128-byte
line.  This module checks the operands, sizes the grid and the workspace
(:func:`rank_geometry`), allocates the workspace through PyTorch's caching
allocator on the current stream, and launches on that stream.  It never
falls back: a tensor off the card, an unsuitable card or a failed launch
raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["THREADS", "TILE_WORDS", "LINE_WORDS", "MAX_TILES", "RankGeometry",
           "rank_geometry", "bitset_rank_cuda"]

THREADS = 256          # kThreads: threads a CTA in both launches
TILE_WORDS = 8192      # kTileWords: words a CTA of launch 1 (8 128-bit loads a thread)
LINE_WORDS = 32        # kLineWords: one line prefix per 128 bytes
MAX_TILES = 8192       # kMaxTiles: tile totals launch 2 scans in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _P, _P, _P]


class RankGeometry(NamedTuple):
    tiles: int            # grid of launch 1 (0: not launched)
    lines: int            # line prefixes launch 1 writes
    answer_ctas: int      # grid of launch 2 (0: not launched)
    workspace_words: int  # int32 workspace: tile totals, then line prefixes
    launches: int         # device launches of one call


def rank_geometry(w: int, q: int) -> RankGeometry:
    """Grids and workspace of one call over a W-word bitset and Q
    positions.  Nothing launches for Q = 0; for W = 0 only launch 2 runs,
    which writes zeros."""
    if w < 0 or q < 0:
        raise ValueError(f"bitset_rank needs W, Q >= 0, got {w}, {q}")
    if 32 * w >= 1 << 31:
        raise ValueError(f"bitset_rank kernel takes at most 2^31 bits, got {32 * w}")
    if q == 0:
        return RankGeometry(0, 0, 0, 0, 0)
    tiles = -(-w // TILE_WORDS)
    lines = -(-w // LINE_WORDS)
    ctas = -(-q // THREADS)
    return RankGeometry(tiles, lines, ctas, tiles + lines, (tiles > 0) + 1)


def bitset_rank_cuda(words: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Inclusive ranks (Q,) int32 of CUDA int32 ``positions`` (Q,) in the
    packed bitset ``words`` (W,)."""
    dev = build.check_operands("bitset_rank", (words, positions), (1, 1))
    geo = rank_geometry(words.shape[0], positions.shape[0])
    out = torch.empty(positions.shape[0], dtype=torch.int32, device=dev)
    work = torch.empty(geo.workspace_words, dtype=torch.int32, device=dev)
    rc = build.launcher("bitset_rank", _ARGTYPES)(
        words.data_ptr(), words.shape[0], positions.data_ptr(), positions.shape[0],
        out.data_ptr(), work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bitset_rank", rc)
    return out
