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
    "bitset_rank_ref",
    "lineage_gather_ref",
    "batched_walk_ref",
    "join_gather_ref",
    "order_key",
    "join_match_ref",
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


def bitset_rank_ref(words: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Inclusive rank oracle over one packed bitset (W,): ``rank(p) =
    popcount(bits[0..p])``, ``rank(p < 0) = 0``, and a position past the
    last bit reads the last bit (the rank of the whole set).  int32 (Q,)."""
    pos = positions.to(torch.int64)
    n_bits = 32 * words.shape[0]
    if n_bits == 0:
        return torch.zeros_like(pos, dtype=torch.int32)
    prefix = torch.cumsum(popcount32(words).to(torch.int64), dim=0)
    p = pos.clamp(0, n_bits - 1)
    w, b = p // 32, p % 32
    masked = (words[w].to(torch.int64) & 0xFFFFFFFF) & ((1 << (b + 1)) - 1)
    before = torch.where(w > 0, prefix[(w - 1).clamp(min=0)], torch.zeros_like(w))
    rank = before + popcount32(masked).to(torch.int64)
    return torch.where(pos < 0, torch.zeros_like(rank), rank).to(torch.int32)


def lineage_gather_ref(queries: torch.Tensor, row_ptr: torch.Tensor,
                       col_idx: torch.Tensor, *, max_deg: int) -> torch.Tensor:
    """Padded (Q, max_deg) int32 neighbour table oracle: row q holds the
    first ``max_deg`` entries of CSR row ``queries[q]`` and -1 after them; a
    query outside ``[0, R)`` gets a row of -1."""
    q = queries.to(torch.int64)
    n_rows = row_ptr.shape[0] - 1
    valid = (q >= 0) & (q < n_rows)
    qs = torch.where(valid, q, torch.zeros_like(q))
    starts = row_ptr[qs].to(torch.int64)
    degs = torch.where(valid, row_ptr[qs + 1].to(torch.int64) - starts, torch.zeros_like(q))
    lane = torch.arange(max_deg, dtype=torch.int64, device=q.device)[None, :]
    live = lane < degs[:, None]
    pos = torch.where(live, starts[:, None] + lane, torch.zeros_like(lane))
    vals = col_idx[pos] if col_idx.numel() else torch.zeros_like(pos, dtype=torch.int32)
    return torch.where(live, vals.to(torch.int32), torch.full_like(pos, -1, dtype=torch.int32))


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


def join_gather_ref(left_data: torch.Tensor, left_null: torch.Tensor, right_data: torch.Tensor,
                    right_null: torch.Tensor, pairs: torch.Tensor, lkey: int, rkey: int) -> tuple:
    """An equi-join's output from its (n, 2) row ``pairs`` (-1 where a side
    is absent): ``(data, null)`` of shape (n, 1 + L + R), the key from the
    left row where there is one, else from the right; then the left's
    non-key columns in order, then the right's; 0.0 with null set where a
    side is absent."""
    lj = [j for j in range(left_data.shape[1]) if j != lkey]
    rj = [j for j in range(right_data.shape[1]) if j != rkey]
    pairs = pairs.to(torch.int64)
    has_l = (pairs[:, 0] >= 0)[:, None]
    has_r = (pairs[:, 1] >= 0)[:, None]
    li = pairs[:, 0].clamp(min=0)
    ri = pairs[:, 1].clamp(min=0)
    data = torch.cat([
        torch.where(has_l, left_data[li, lkey: lkey + 1], right_data[ri, rkey: rkey + 1]),
        torch.where(has_l, left_data[li][:, lj], 0.0),
        torch.where(has_r, right_data[ri][:, rj], 0.0),
    ], dim=1)
    null = torch.cat([
        torch.where(has_l, left_null[li, lkey: lkey + 1], right_null[ri, rkey: rkey + 1]),
        torch.where(has_l, left_null[li][:, lj], True),
        torch.where(has_r, right_null[ri][:, rj], True),
    ], dim=1)
    return data, null


def order_key(keys: torch.Tensor) -> torch.Tensor:
    """float32 keys -> int64 keys in [0, 2^32) that sort as numpy sorts the
    floats: every NaN last and equal to every other, ``-0.0`` equal to
    ``0.0``.  The float's bits with the sign flipped for positives and all
    bits flipped for negatives, the sortable image of IEEE 754."""
    bits = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits | 0x80000000)
    return torch.where(torch.isnan(keys), 0xFFFFFFFF, key)


def join_match_ref(left_keys: torch.Tensor, right_sorted: torch.Tensor,
                   right_order: torch.Tensor) -> tuple:
    """An equi-join's row pairs from its float32 left keys (L,), the right
    keys stably sorted (R,) and the sort's int64 order (R,): ``(counts,
    offsets, pairs)``, each left row's int32 match count and exclusive
    offset into the int32 ``pairs`` (total, 2) of (left row, right row),
    left rows ascending and each row's matches in sorted-key order.  Keys
    compare as :func:`order_key` orders them, which is numpy's order.
    Reads the total once from the device."""
    rk, lk = order_key(right_sorted), order_key(left_keys)
    lo = torch.searchsorted(rk, lk)
    counts = torch.searchsorted(rk, lk, right=True) - lo
    total = int(counts.sum())
    offsets = torch.cumsum(counts, dim=0) - counts
    dev = left_keys.device
    l_rows = torch.repeat_interleave(torch.arange(len(lk), dtype=torch.int64, device=dev),
                                     counts, output_size=total)
    flat = torch.repeat_interleave(lo - offsets, counts, output_size=total) \
        + torch.arange(total, dtype=torch.int64, device=dev)
    pairs = torch.stack([l_rows, right_order[flat]], dim=1).to(torch.int32)
    return counts.to(torch.int32), offsets.to(torch.int32), pairs
