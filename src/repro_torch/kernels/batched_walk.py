"""Launcher of the fused K-hop batched-walk CUDA kernel.

The kernel (``csrc/batched_walk.cu``) replaces the TPU kernel
``repro/kernels/batched_walk.py::batched_walk_kernel``.  On an H100 it is
bound by latency, not bytes: at the main path's shape (Compas, K = 7 hops,
B = 64 probes of about 8 rows) the plane rows it must read take about a
microsecond at the memory rate, while the hops run one after the other
and each hop waits on its row loads.  The kernel therefore compacts each
hop's selected rows once per CTA into a shared list, keeps eight
independent row loads in flight per thread, and fills the card with one
CTA per probe at B = 64.  Its note says more, and what is still open.

This module checks the operands, chooses the launch geometry
(:func:`walk_geometry`: probes per CTA, row-list capacity, thread slices
per list, all within the shared memory of one block) and launches on
PyTorch's current stream.  It never falls back: an unsuitable card, a
frontier too wide for shared memory or a failed launch raises.

The planes go in as a per-hop table of (device address, rows n_j, words
W_{j+1}) that rides in the kernel's parameters, so every hop keeps its own
dims (no square padding), the memoized planes are read where they lie, and
nothing is copied to the device before the launch.  A chain may have at
most :data:`MAX_HOPS` hops.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["SMEM_BYTES", "MAX_HOPS", "SMS", "WalkGeometry", "walk_smem_bytes",
           "pick_block_b", "walk_geometry", "batched_walk_cuda"]

SMEM_BYTES = 232448          # shared memory one block may use on sm_90
STATIC_SMEM_BYTES = 128      # the kernel's static shared memory (scan sums, counters)
MAX_HOPS = 64                # kMaxHops of the kernel's parameter table
SMS = 132                    # streaming multiprocessors of an H100 SXM
THREADS = 256                # kThreads
MIN_CAP = 128                # 32 rows x kGroupsPerThread: one thread's most entries
MAX_CAP = 4096               # row-list entries per round
_BLOCKS_B = (8, 4, 2, 1)     # probe blocks the kernel is instantiated for

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, ctypes.POINTER(ctypes.c_longlong), _I, _P, _I, _P, _I, _I, _I, _I, _P]


class WalkGeometry(NamedTuple):
    block_b: int      # probes per CTA
    cap: int          # row-list entries per round
    slices: int       # groups of threads splitting each row list
    smem_bytes: int   # shared memory of one CTA, static part included


def walk_smem_bytes(block_b: int, w_max: int, cap: int) -> int:
    """Shared memory of one CTA: frontiers ``cur`` and ``nxt`` (2 * bb *
    w_max words), the row list (``cap`` words) and the static part."""
    return 4 * (2 * block_b * w_max + cap) + STATIC_SMEM_BYTES


def pick_block_b(w_max: int, b: int) -> int:
    """Probes per CTA for a batch of ``b`` probes: the largest of 8, 4, 2, 1
    that still gives every SM a CTA and, with the smallest row list, fits in
    one block's shared memory; 1 when even one probe per CTA leaves SMs
    empty.  Raises for a frontier too wide for one probe."""
    fitting = [bb for bb in _BLOCKS_B if walk_smem_bytes(bb, w_max, MIN_CAP) <= SMEM_BYTES]
    if not fitting:
        raise ValueError(
            f"frontier of {w_max} words ({w_max * 32} rows) is too wide for the "
            f"batched_walk kernel: even one probe needs {walk_smem_bytes(1, w_max, MIN_CAP)} "
            f"bytes of shared memory, the card gives {SMEM_BYTES}")
    for bb in fitting:
        if -(-b // bb) >= SMS:
            return bb
    return fitting[-1]


def walk_geometry(b: int, w_max: int) -> WalkGeometry:
    """The kernel's launch geometry for ``b`` probes over frontiers at most
    ``w_max`` words wide: the probe block of :func:`pick_block_b`, the
    largest power-of-two row list up to :data:`MAX_CAP` that fits beside
    the frontiers, and as many thread slices per list (1 to 8) as leave one
    thread per frontier word."""
    bb = pick_block_b(w_max, b)
    cap = MAX_CAP
    while walk_smem_bytes(bb, w_max, cap) > SMEM_BYTES:
        cap //= 2
    slices = 1
    while slices < 8 and THREADS // (2 * slices) >= 32 * -(-w_max // 32):
        slices *= 2
    return WalkGeometry(bb, cap, slices, walk_smem_bytes(bb, w_max, cap))


def batched_walk_cuda(mask_bits: torch.Tensor,
                      planes: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA int32 operands already checked for chain
    consistency.  Returns ``(out_bits (B, W_K) int32, counts (K, B) int32)``."""
    dev = build.check_operands("batched_walk", (mask_bits, *planes), [2] * (1 + len(planes)))
    b, mask_words = mask_bits.shape
    k = len(planes)
    if k > MAX_HOPS:
        raise ValueError(f"batched_walk kernel takes at most {MAX_HOPS} hops, got {k}")
    out_words = planes[-1].shape[1]
    w_max = max([1, mask_words] + [p.shape[1] for p in planes])
    geo = walk_geometry(b, w_max)
    out = torch.empty((b, out_words), dtype=torch.int32, device=dev)
    counts = torch.empty((k, b), dtype=torch.int32, device=dev)
    if b == 0:
        return out, counts
    table = [v for p in planes for v in (p.data_ptr(), p.shape[0], p.shape[1])]
    rc = build.launcher("batched_walk", _ARGTYPES)(
        mask_bits.data_ptr(), b, mask_words, (ctypes.c_longlong * len(table))(*table), k,
        out.data_ptr(), out_words, counts.data_ptr(), geo.block_b, w_max, geo.cap,
        geo.slices, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("batched_walk", rc)
    return out, counts
