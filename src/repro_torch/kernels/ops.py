"""Public kernel entry points: operand checks, device dispatch, launch counts.

Dispatch is by the device of the operands, never by a flag:

* CPU tensors take the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* CUDA tensors take the hand-written kernel, or the call raises (no card
  of capability (9, 0), a failed build or launch, a frontier too wide for
  shared memory).  Nothing falls back to the plain version.

``launch_counts()`` counts the dispatches of each entry: on CUDA the launch
of the kernel, counted right after it was accepted; on the CPU the call of
its plain version, the CPU's stand-in for the kernel.  ``bitplane_probe``
is the same contraction as ``bitmatmul`` and counts as a ``bitmatmul``
launch; ``join_match`` counts once a call for its two launches.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.batched_walk import batched_walk_cuda
from repro_torch.kernels.bitmatmul import bitmatmul_cuda
from repro_torch.kernels.bitset_rank import bitset_rank_cuda
from repro_torch.kernels.join_gather import check_join_operands, join_gather_cuda
from repro_torch.kernels.join_match import (check_match_operands, check_match_total,
                                            join_match_cuda)
from repro_torch.kernels.lineage_gather import lineage_gather_cuda

__all__ = [
    "bitmatmul",
    "bitplane_probe",
    "bitset_rank",
    "lineage_gather",
    "batched_walk",
    "batched_walk_unfused",
    "join_gather",
    "join_match",
    "launch_counts",
    "reset_launch_counts",
]

_LAUNCHES: Dict[str, int] = {}


def _note_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict:
    """{kernel entry: dispatch count} since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of the operands; raises for several devices and for
    a device that is neither the CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} operands lie on several devices: {devices}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for device {dev}")
    return dev


# ---------------------------------------------------------------------------
# bitmatmul: the hop-cache's composition and probe contraction
# ---------------------------------------------------------------------------
def bitmatmul(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(OR, AND)-compose packed relations: A (M, ceil(K/32)) x B (K, Nw) ->
    (M, Nw) int32.  Bits of A past B's K rows select nothing."""
    m, kw = a_bits.shape
    k, nw = b_bits.shape
    if not ((kw - 1) * 32 < k <= kw * 32):
        raise ValueError(f"contraction mismatch: A packs {kw * 32} cols, B has {k} rows")
    dev = _device("bitmatmul", a_bits, b_bits)
    if dev.type == "cpu":
        _note_launch("bitmatmul")
        return ref.bitmatmul_ref(a_bits, b_bits)
    out = bitmatmul_cuda(a_bits.contiguous(), b_bits.contiguous())
    _note_launch("bitmatmul")
    return out


def bitplane_probe(mask_bits: torch.Tensor, plane_bits: torch.Tensor) -> torch.Tensor:
    """Batched lineage probe of a composed relation (the hop-cache hot
    path): ``mask_bits`` (B, ceil(K/32)) packs B row-selector sets, and row
    b of the result packs the union of the ``plane_bits`` (K, Nw) rows that
    probe b selects.  The same contraction as :func:`bitmatmul`."""
    return bitmatmul(mask_bits, plane_bits)


# ---------------------------------------------------------------------------
# bitset_rank / lineage_gather: the per-hop baseline's rank and gather
# ---------------------------------------------------------------------------
def bitset_rank(words: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Batched inclusive rank over one packed bitset: ``words`` (W,) int32,
    ``positions`` (Q,) int32 -> (Q,) int32; ``pos < 0`` ranks 0."""
    if words.dim() != 1 or positions.dim() != 1:
        raise ValueError("bitset_rank takes a 1-D bitset and 1-D positions")
    dev = _device("bitset_rank", words, positions)
    if dev.type == "cpu":
        _note_launch("bitset_rank")
        return ref.bitset_rank_ref(words, positions)
    out = bitset_rank_cuda(words.contiguous(), positions.to(torch.int32).contiguous())
    _note_launch("bitset_rank")
    return out


def lineage_gather(row_ptr: torch.Tensor, col_idx: torch.Tensor, queries: torch.Tensor,
                   *, max_deg: int) -> torch.Tensor:
    """Batched CSR probe -> (Q, max(max_deg, 1)) int32 neighbour table, -1
    past each row's degree.  Neither the kernel nor its plain version reads
    past a row's degree, so ``col_idx`` needs none of the sentinel padding
    ``repro``'s wrapper adds for its fixed-width window."""
    md = max(int(max_deg), 1)
    dev = _device("lineage_gather", row_ptr, col_idx, queries)
    if dev.type == "cpu":
        _note_launch("lineage_gather")
        return ref.lineage_gather_ref(queries, row_ptr, col_idx, max_deg=md)
    out = lineage_gather_cuda(queries.to(torch.int32).contiguous(),
                              row_ptr.to(torch.int32).contiguous(),
                              col_idx.to(torch.int32).contiguous(), md)
    _note_launch("lineage_gather")
    return out


# ---------------------------------------------------------------------------
# batched_walk: the fused K-hop record probe, and its per-hop baseline
# ---------------------------------------------------------------------------
def _check_walk_chain(mask_bits: torch.Tensor, planes: Sequence[torch.Tensor]) -> None:
    kw = mask_bits.shape[1]
    for j, plane in enumerate(planes):
        rows = plane.shape[0]
        if not ((kw - 1) * 32 < rows <= kw * 32):
            raise ValueError(
                f"hop {j}: frontier packs {kw * 32} cols, plane has {rows} rows"
            )
        kw = plane.shape[1]


def batched_walk(mask_bits: torch.Tensor, planes: Sequence[torch.Tensor]):
    """K-hop batched record probe in ONE kernel launch.

    ``mask_bits`` (B, ceil(n_0/32)) int32 packs B probe sets over the chain's
    entry dim; ``planes[j]`` is hop j's packed (n_j, ceil(n_{j+1}/32)) int32
    relation bitplane.  Returns ``(out_bits (B, ceil(n_K/32)) int32, counts
    (K, B) int32)``: the final frontier and each hop's per-probe frontier
    size.
    """
    planes = list(planes)
    if not planes:
        raise ValueError("batched_walk needs at least one hop")
    _check_walk_chain(mask_bits, planes)
    dev = _device("batched_walk", mask_bits, *planes)
    if dev.type == "cpu":
        _note_launch("batched_walk")
        return ref.batched_walk_ref(mask_bits, planes)
    out = batched_walk_cuda(mask_bits, planes)
    _note_launch("batched_walk")
    return out


def batched_walk_unfused(mask_bits: torch.Tensor, planes: Sequence[torch.Tensor]):
    """The per-hop baseline the fused kernel replaces: K x 3 launches.

    Per hop: :func:`bitplane_probe` (the select-OR contraction),
    :func:`bitset_rank` over the flattened frontier bitset (per-probe
    frontier sizes as rank differences at row boundaries), and
    :func:`lineage_gather` of the frontier's padded neighbour table from its
    CSR, rebuilt on the operands' device each hop.  Returns what
    :func:`batched_walk` returns, byte for byte.
    """
    planes = list(planes)
    if not planes:
        raise ValueError("batched_walk needs at least one hop")
    _check_walk_chain(mask_bits, planes)
    dev = _device("batched_walk_unfused", mask_bits, *planes)
    cur = mask_bits
    b = cur.shape[0]
    all_counts = []
    for plane in planes:
        cur = bitplane_probe(cur, plane)
        w = cur.shape[1]
        ends = torch.arange(1, b + 1, dtype=torch.int32, device=dev) * (w * 32) - 1
        ranks = bitset_rank(cur.reshape(-1), ends)
        counts = torch.diff(ranks, prepend=torch.zeros(1, dtype=torch.int32, device=dev))
        all_counts.append(counts.to(torch.int32))
        # the frontier's CSR: row b lists probe b's set bits, in order
        row_ptr = torch.zeros(b + 1, dtype=torch.int32, device=dev)
        row_ptr[1:] = torch.cumsum(counts, dim=0)
        col_idx = torch.nonzero(ref.unpack_bits(cur, w * 32))[:, 1].to(torch.int32)
        lineage_gather(row_ptr, col_idx, torch.arange(b, dtype=torch.int32, device=dev),
                       max_deg=int(counts.max()) if b else 1)
    return cur, torch.stack(all_counts, dim=0)


# ---------------------------------------------------------------------------
# join_gather: a captured join's output, assembled from its row pairs
# ---------------------------------------------------------------------------
def join_gather(left_data: torch.Tensor, left_null: torch.Tensor, right_data: torch.Tensor,
                right_null: torch.Tensor, pairs: torch.Tensor, lkey: int, rkey: int) -> tuple:
    """``(data, null)`` of an equi-join from its (n, 2) int32 row ``pairs``
    (-1 where a side is absent): column 0 the left key, or the right where
    the left row is absent, then the left's non-key columns in order, then
    the right's; 0.0 with null set where a side is absent.  The tables'
    float32 ``data`` and bool ``null`` and the pairs are contiguous."""
    dev = _device("join_gather", left_data, left_null, right_data, right_null, pairs)
    if dev.type == "cpu":
        check_join_operands(left_data, left_null, right_data, right_null, pairs, lkey, rkey)
        _note_launch("join_gather")
        return ref.join_gather_ref(left_data, left_null, right_data, right_null, pairs,
                                   lkey, rkey)
    out = join_gather_cuda(left_data, left_null, right_data, right_null, pairs, lkey, rkey)
    _note_launch("join_gather")
    return out


# ---------------------------------------------------------------------------
# join_match: a captured join's row pairs, from its sorted right keys
# ---------------------------------------------------------------------------
def join_match(left_keys: torch.Tensor, right_sorted: torch.Tensor,
               right_order: torch.Tensor) -> tuple:
    """``(counts, offsets, pairs)`` of an equi-join: each left row's int32
    match count and exclusive offset, and the contiguous (total, 2) int32
    (left row, right row) pairs, left rows ascending, each row's matches in
    the order of the stable sort that gave ``right_sorted`` (float32) and
    ``right_order`` (int64).  Keys compare in numpy's order: NaN matches
    NaN, ``-0.0`` matches ``0.0``; ``right_sorted`` is ascending in it, every
    NaN last (the card's sort puts a NaN with its sign bit set first, so
    ``ops.join`` makes every NaN one before it sorts).  Reads the total once
    from the device."""
    dev = _device("join_match", left_keys, right_sorted, right_order)
    if dev.type == "cpu":
        check_match_operands(left_keys, right_sorted, right_order)
        _note_launch("join_match")
        out = ref.join_match_ref(left_keys, right_sorted, right_order)
        check_match_total(out[2].shape[0])
        return out
    out = join_match_cuda(left_keys, right_sorted, right_order)
    _note_launch("join_match")
    return out
