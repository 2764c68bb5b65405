"""Launcher of the packed (OR, AND) matrix-product CUDA kernel.

The kernel (``csrc/bitmatmul.cu``) replaces the TPU kernel
``repro/kernels/bitmatmul.py::bitmatmul_kernel``.  On an H100 it is bound
by bytes at the hop-cache's compositions (A read once, the selected B rows
once per tile of 8 rows, C written once) and by latency at its probes (64
rows of A with a few bits each, whose bytes take well under a
microsecond).  The kernel compacts each 8-row tile's selected B rows once
into a shared list, has every thread issue eight independent loads per
output word it owns before it ORs, and splits C's words across CTAs when
the row tiles alone would leave the card mostly empty.  Its note says
more, and what is still open.

This module checks the operands, chooses the grid
(:func:`bitmatmul_geometry`) and launches on PyTorch's current stream.  It
never falls back: an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["SMS", "TILE_ROWS", "SLICE_WORDS", "BitmatmulGeometry", "bitmatmul_smem_bytes",
           "bitmatmul_geometry", "bitmatmul_cuda"]

SMS = 132                    # streaming multiprocessors of an H100 SXM
TILE_ROWS = 8                # kTM: rows of C per CTA
SLICE_WORDS = (1024, 512, 256, 128, 64, 32)   # words of C per CTA the kernel takes
MAX_WORD_SLICES = 65535      # grid.y
LIST_CAP = 2048              # kCap: row-list entries per round

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


class BitmatmulGeometry(NamedTuple):
    row_tiles: int     # grid.x: tiles of TILE_ROWS rows of C (1 when M = 0)
    word_slices: int   # grid.y: slices of slice_words words of C
    slice_words: int   # words of C per CTA; below 256 the row list is split too


def bitmatmul_smem_bytes(slice_words: int) -> int:
    """Shared memory of one CTA: the row list (an int32 row and a byte of
    pattern per entry), the merge buffer of the slices below 256 words
    (TILE_ROWS x slice_words words) and the scan's sums and counter."""
    merged = TILE_ROWS * slice_words if slice_words < 256 else 1
    return LIST_CAP * 5 + 4 * merged + 4 * (256 // 32 + 1)


def bitmatmul_geometry(m: int, nw: int) -> BitmatmulGeometry:
    """The grid for C (m, nw).  Whole rows per CTA (the smallest slice of
    256, 512 or 1024 words that covers ``nw``, or slices of 1024 beyond),
    so that A is read once, while the row tiles give at least 2 x
    :data:`SMS` CTAs; with fewer tiles the slice halves, down to 32 words,
    until the grid reaches 2 x :data:`SMS` CTAs."""
    tiles = max(1, -(-m // TILE_ROWS))
    sw = next((s for s in (256, 512, 1024) if s >= nw), 1024)
    while tiles * max(1, -(-nw // sw)) < 2 * SMS and sw > SLICE_WORDS[-1]:
        sw //= 2
    slices = max(1, -(-nw // sw))
    if slices > MAX_WORD_SLICES:
        raise ValueError(f"bitmatmul kernel takes at most {MAX_WORD_SLICES * sw} output "
                         f"words per row, got {nw}")
    return BitmatmulGeometry(tiles, slices, sw)


def bitmatmul_cuda(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """``C = A (OR, AND) B`` for CUDA int32 operands already checked for the
    contraction: A (M, Kw), B (K, Nw) -> C (M, Nw)."""
    dev = build.check_operands("bitmatmul", (a_bits, b_bits), (2, 2))
    m, kw = a_bits.shape
    k, nw = b_bits.shape
    geo = bitmatmul_geometry(m, nw)
    out = torch.empty((m, nw), dtype=torch.int32, device=dev)
    rc = build.launcher("bitmatmul", _ARGTYPES)(
        a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(), m, kw, k, nw,
        geo.slice_words, geo.word_slices, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bitmatmul", rc)
    return out
