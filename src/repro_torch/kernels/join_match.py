"""Launcher of the join's row-pair CUDA kernel.

The kernel (``csrc/join_match.cu``) replaces no TPU kernel; its note says
why it was added, what bounds it on an H100 and what the design does about
it.  Launch 1 finds each left key's run of equal right keys (one search a
key, its top levels in shared memory, the run's end by a galloping step)
and writes the counts and their exclusive scan; the host reads the total
once; launch 2 writes the pairs, each block owning a run of consecutive
output pairs.  This module checks the operands (:func:`check_match_operands`,
which the entry in :mod:`repro_torch.kernels.ops` runs on the CPU too),
sizes the launches (:func:`match_geometry`), allocates the outputs and the
scratch and launches on PyTorch's current stream.  It never falls back: a
tensor off the card, an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["THREADS", "ITEMS", "TILE_ROWS", "MAX_SPLITTERS", "OUT_ITEMS", "OUT_TILE",
           "MatchGeometry", "match_geometry", "check_match_operands", "check_match_total",
           "join_match_cuda"]

THREADS = 256                  # kThreads: threads a CTA in both launches
ITEMS = 4                      # kItems: left keys a thread of launch 1 searches side by side
TILE_ROWS = THREADS * ITEMS    # kTile: left rows a tile of launch 1
MAX_SPLITTERS = 4096           # kMaxSplit: sorted keys a CTA keeps in shared memory
OUT_ITEMS = 8                  # kOutItems: pairs a thread of launch 2 writes
OUT_TILE = THREADS * OUT_ITEMS  # kOutTile: consecutive pairs a CTA of launch 2 owns

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P, _P]
_MAX_ROWS = (1 << 31) - 1 - OUT_TILE


class MatchGeometry(NamedTuple):
    tiles: int          # tiles of launch 1 (0: not launched)
    stride: int         # sorted positions between two splitters
    splitters: int      # splitters: the keys at positions 0, stride, 2 stride, ...
    scratch_words: int  # int64 scratch: ticket, total, one status word a tile


def match_geometry(n_left: int, n_right: int) -> MatchGeometry:
    """Tiles, splitter stride and scratch of launch 1 over L left and R
    right keys: at most :data:`MAX_SPLITTERS` splitters, a power-of-two
    stride apart, so every search below them takes the same log2(stride)
    steps."""
    if n_left < 0 or n_right < 0:
        raise ValueError(f"join_match needs L, R >= 0, got {n_left}, {n_right}")
    tiles = -(-n_left // TILE_ROWS)
    stride = 1 << (max(1, -(-n_right // MAX_SPLITTERS)) - 1).bit_length()
    return MatchGeometry(tiles, stride, -(-n_right // stride), 2 + tiles)


def check_match_operands(left_keys: torch.Tensor, right_sorted: torch.Tensor,
                         right_order: torch.Tensor) -> None:
    """Raise unless the left keys and the sorted right keys are contiguous
    1-D float32, the order a contiguous int64 tensor of the right keys'
    length, and each side has fewer than 2^31 rows."""
    for what, t, dtype in (("left keys", left_keys, torch.float32),
                           ("sorted right keys", right_sorted, torch.float32),
                           ("right order", right_order, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"join_match takes contiguous 1-D {dtype} {what}; "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.shape[0] > _MAX_ROWS:
            raise ValueError(f"join_match takes fewer than 2^31 {what}")
    if right_order.shape[0] != right_sorted.shape[0]:
        raise ValueError(f"join_match: {right_sorted.shape[0]} sorted right keys but an "
                         f"order of {right_order.shape[0]}")


def check_match_total(total: int) -> None:
    """Raise unless ``total`` pairs fit the kernels' int32 row pairs."""
    if total > _MAX_ROWS:
        raise ValueError(f"join_match takes fewer than 2^31 pairs; the join has {total}")


def join_match_cuda(left_keys: torch.Tensor, right_sorted: torch.Tensor,
                    right_order: torch.Tensor) -> tuple:
    """``(counts, offsets, pairs)`` of the equi-join of CUDA operands as
    :func:`check_match_operands` takes them; what
    :func:`repro_torch.kernels.ref.join_match_ref` returns.  Reads the total
    once from the device, between the two launches."""
    dev = build.check_card("join_match", left_keys.device)
    if right_sorted.device != dev or right_order.device != dev:
        raise ValueError("join_match kernel takes its operands on one device")
    check_match_operands(left_keys, right_sorted, right_order)
    nl, nr = left_keys.shape[0], right_sorted.shape[0]
    geo = match_geometry(nl, nr)
    counts = torch.empty(nl, dtype=torch.int32, device=dev)
    offsets = torch.empty(nl, dtype=torch.int32, device=dev)
    start = torch.empty(nl, dtype=torch.int32, device=dev)   # sorted start less offset
    scratch = torch.empty(geo.scratch_words, dtype=torch.int64, device=dev)
    launch = build.launcher("join_match", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(phase, total, pairs):
        rc = launch(phase, left_keys.data_ptr(), nl, right_sorted.data_ptr(),
                    right_order.data_ptr(), nr, geo.stride, geo.splitters, geo.tiles,
                    counts.data_ptr(), offsets.data_ptr(), start.data_ptr(),
                    scratch.data_ptr(), total, pairs, stream)
        build.check_launch("join_match", rc)

    run(1, 0, None)
    total = int(scratch[1])
    check_match_total(total)
    pairs = torch.empty((total, 2), dtype=torch.int32, device=dev)
    if total:
        run(2, total, pairs.data_ptr())
    return counts, offsets, pairs
