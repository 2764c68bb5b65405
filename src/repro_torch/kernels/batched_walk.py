"""Launcher of the fused K-hop batched-walk CUDA kernel.

The kernel (``csrc/batched_walk.cu``) replaces the TPU kernel
``repro/kernels/batched_walk.py::batched_walk_kernel``; its note says what
bounds it on an H100 and what the design does about it.  This module
checks the operands, picks the probe block from the shared-memory budget,
and launches on PyTorch's current stream.  It never falls back: an
unsuitable card, a frontier too wide for shared memory or a failed launch
raises.

The planes go in as a per-hop table of (device address, rows n_j, words
W_{j+1}) that rides in the kernel's parameters, so every hop keeps its own
dims (no square padding), the memoized planes are read where they lie, and
nothing is copied to the device before the launch.  A chain may have at
most :data:`MAX_HOPS` hops.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["SMEM_BYTES", "MAX_HOPS", "pick_block_b", "batched_walk_cuda"]

SMEM_BYTES = 232448          # dynamic shared memory one block may use on sm_90
MAX_HOPS = 64                # kMaxHops of the kernel's parameter table
_BLOCKS_B = (8, 4, 2, 1)     # probe blocks the kernel is instantiated for


def _lib() -> ctypes.CDLL:
    lib = build.load("batched_walk")
    fn = lib.batched_walk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, ctypes.POINTER(ctypes.c_longlong), i, p, i, p, i, i, p]
        fn.restype = ctypes.c_int
        lib.batched_walk_error_string.argtypes = [ctypes.c_int]
        lib.batched_walk_error_string.restype = ctypes.c_char_p
    return lib


def pick_block_b(w_max: int) -> int:
    """The largest probe block whose ``cur`` and ``nxt`` frontiers
    (2 * bb * w_max int32 words) fit in one block's shared memory."""
    for bb in _BLOCKS_B:
        if 2 * bb * w_max * 4 <= SMEM_BYTES:
            return bb
    raise ValueError(
        f"frontier of {w_max} words ({w_max * 32} rows) is too wide for the "
        f"batched_walk kernel: even one probe needs {8 * w_max} bytes of "
        f"shared memory, the card gives {SMEM_BYTES}")


def batched_walk_cuda(mask_bits: torch.Tensor,
                      planes: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA int32 operands already checked for chain
    consistency.  Returns ``(out_bits (B, W_K) int32, counts (K, B) int32)``."""
    dev = mask_bits.device
    if torch.cuda.get_device_capability(dev) < (9, 0):
        raise RuntimeError(
            f"batched_walk kernel is built for sm_90a; {torch.cuda.get_device_name(dev)} "
            f"has capability {torch.cuda.get_device_capability(dev)}")
    for t in (mask_bits, *planes):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                "batched_walk kernel takes contiguous 2-D int32 tensors on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device}")
    b, mask_words = mask_bits.shape
    k = len(planes)
    if k > MAX_HOPS:
        raise ValueError(f"batched_walk kernel takes at most {MAX_HOPS} hops, got {k}")
    out_words = planes[-1].shape[1]
    w_max = max([1, mask_words] + [p.shape[1] for p in planes])
    bb = pick_block_b(w_max)
    out = torch.empty((b, out_words), dtype=torch.int32, device=dev)
    counts = torch.empty((k, b), dtype=torch.int32, device=dev)
    if b == 0:
        return out, counts
    table = [v for p in planes for v in (p.data_ptr(), p.shape[0], p.shape[1])]
    lib = _lib()
    rc = lib.batched_walk_launch(
        mask_bits.data_ptr(), b, mask_words, (ctypes.c_longlong * len(table))(*table), k,
        out.data_ptr(), out_words, counts.data_ptr(), bb, w_max,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("batched_walk kernel launch failed: "
                           + lib.batched_walk_error_string(rc).decode())
    return out, counts
