"""Launcher of the join-output CUDA kernel.

The kernel (``csrc/join_gather.cu``) replaces no TPU kernel; its note says
why it was added, what bounds it on an H100 and what the design does about
it: a warp owns 32 consecutive output rows, one pair a lane, and writes
their ``32 x C`` contiguous data words and null bytes once, each word
loaded from the input row its pair names.  This module checks the
operands (:func:`check_join_operands`, which the entry in
:mod:`repro_torch.kernels.ops` runs on the CPU too), allocates the output
and launches on PyTorch's current stream.  It never falls back: a tensor
off the card, an unsuitable card or a failed launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["THREADS", "ROWS_PER_WARP", "check_join_operands", "join_gather_cuda"]

THREADS = 256          # kThreads
ROWS_PER_WARP = 32     # kRows: output rows a warp, one pair a lane

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P]
_MAX_ROWS = (1 << 31) - 1 - THREADS


def check_join_operands(left_data: torch.Tensor, left_null: torch.Tensor,
                        right_data: torch.Tensor, right_null: torch.Tensor,
                        pairs: torch.Tensor, lkey: int, rkey: int) -> None:
    """Raise unless each table is a contiguous 2-D float32 ``data`` with a
    contiguous bool ``null`` of its shape, ``pairs`` a contiguous (n, 2)
    int32 tensor, each key a column of its table and every count below
    2^31."""
    for side, data, null, key in (("left", left_data, left_null, lkey),
                                  ("right", right_data, right_null, rkey)):
        if data.dtype != torch.float32 or data.dim() != 2 or not data.is_contiguous():
            raise ValueError(f"join_gather takes a contiguous 2-D float32 {side} data; "
                             f"got {data.dtype} {tuple(data.shape)}")
        if null.dtype != torch.bool or null.shape != data.shape or not null.is_contiguous():
            raise ValueError(f"join_gather takes a contiguous bool {side} null of its data's "
                             f"shape; got {null.dtype} {tuple(null.shape)}")
        if not 0 <= key < data.shape[1]:
            raise ValueError(f"join_gather: {side} key {key} is not a column of "
                             f"{data.shape[1]}")
        if data.shape[0] > _MAX_ROWS:
            raise ValueError(f"join_gather takes fewer than 2^31 {side} rows")
    if (pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2
            or not pairs.is_contiguous()):
        raise ValueError(f"join_gather takes contiguous (n, 2) int32 pairs; "
                         f"got {pairs.dtype} {tuple(pairs.shape)}")
    if pairs.shape[0] > _MAX_ROWS:
        raise ValueError("join_gather takes fewer than 2^31 pairs")


def join_gather_cuda(left_data: torch.Tensor, left_null: torch.Tensor,
                     right_data: torch.Tensor, right_null: torch.Tensor,
                     pairs: torch.Tensor, lkey: int, rkey: int) -> tuple:
    """``(data, null)`` (n, cl + cr - 1) of the join whose CUDA int32 row
    ``pairs`` (n, 2) pick rows of the two tables; operands as
    :func:`check_join_operands` takes them."""
    dev = build.check_card("join_gather", pairs.device)
    if any(t.device != dev for t in (left_data, left_null, right_data, right_null)):
        raise ValueError("join_gather kernel takes its operands on one device")
    check_join_operands(left_data, left_null, right_data, right_null, pairs, lkey, rkey)
    if pairs.data_ptr() % 8:
        raise ValueError("join_gather kernel loads each pair as 8 bytes; the pairs "
                         "start off an 8-byte boundary")
    (nl, cl), (nr, cr), n = left_data.shape, right_data.shape, pairs.shape[0]
    data = torch.empty((n, cl + cr - 1), dtype=torch.float32, device=dev)
    null = torch.empty((n, cl + cr - 1), dtype=torch.bool, device=dev)
    rc = build.launcher("join_gather", _ARGTYPES)(
        left_data.data_ptr(), left_null.data_ptr(), nl, cl, lkey,
        right_data.data_ptr(), right_null.data_ptr(), nr, cr, rkey,
        pairs.data_ptr(), n, data.data_ptr(), null.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("join_gather", rc)
    return data, null
