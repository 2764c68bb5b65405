"""Plain PyTorch versions of the kernels (the port's oracles).

Packed bit words are stored as **int32** (torch has no usable uint32 on the
CPU: no shifts, no max).  Bit j of word w is column 32w + j, the
little-endian layout of ``repro``; an int32 word with bit 31 set is
negative, and ``.numpy().view(np.uint32)`` gives ``repro``'s words.

These run on whatever device their inputs lie on.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` call them only for CPU tensors; on the card
they are the reference that ``chip_smoke.py`` holds each kernel against.
"""
from __future__ import annotations

import torch

__all__ = [
    "wrap_int32",
    "pack_bits",
    "unpack_bits",
    "popcount32",
    "bitmatmul_ref",
    "batched_walk_ref",
]


def _shifts(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.arange(32, dtype=dtype, device=device)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_bits(dense: torch.Tensor) -> torch.Tensor:
    """bool (R, C) -> int32 (R, ceil(C/32)), little-endian within a word."""
    r, c = dense.shape
    cw = (c + 31) // 32
    padded = torch.zeros((r, cw * 32), dtype=torch.int64, device=dense.device)
    padded[:, :c] = dense.to(torch.int64)
    words = (padded.view(r, cw, 32) << _shifts(dense.device, torch.int64)).sum(dim=-1)
    return wrap_int32(words)


def unpack_bits(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """int32 (R, W) -> bool (R, n_cols).  ``>>`` on int32 is arithmetic, so
    each bit is read as ``(x >> j) & 1``."""
    r, cw = words.shape
    bits = (words[:, :, None] >> _shifts(words.device, torch.int32)) & 1
    return bits.reshape(r, cw * 32)[:, :n_cols].to(torch.bool)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 words (SWAR in int64, so the sign
    bit cannot leak into the arithmetic)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def bitmatmul_ref(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(OR, AND) matmul oracle: unpack, 0/1 float32 matmul, threshold,
    repack.  ``torch.matmul`` has no int32 kernel on CUDA; a float32 product
    of 0/1 entries is exact while the contraction is below 2^24, provided
    TF32 is off, which this function sets for its own call."""
    k = b_bits.shape[0]
    nw = b_bits.shape[1]
    a = unpack_bits(a_bits, k).to(torch.float32)          # (m, k)
    b = unpack_bits(b_bits, nw * 32).to(torch.float32)    # (k, n)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = (a @ b) > 0                                   # boolean semiring
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return pack_bits(c)


def batched_walk_ref(mask_bits: torch.Tensor, planes) -> tuple:
    """K-hop fused-walk oracle: fold :func:`bitmatmul_ref` over the chain.

    ``mask_bits`` (B, ceil(n_0/32)) packs B probe sets; ``planes[j]`` is the
    packed (n_j, ceil(n_{j+1}/32)) relation of hop j.  Returns the final
    packed frontier (B, ceil(n_K/32)) and the per-hop frontier sizes (K, B)
    int32.
    """
    cur = mask_bits
    counts = []
    for plane in planes:
        cur = bitmatmul_ref(cur, plane)
        counts.append(popcount32(cur).sum(dim=1, dtype=torch.int32))
    return cur, torch.stack(counts, dim=0)
