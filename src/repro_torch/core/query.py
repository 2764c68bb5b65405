"""Provenance query processing (paper Section IV, Table VII: Q1-Q11).

The physical layer under :mod:`repro_torch.provenance`:
record-level queries chain ``project(slice(T, p_in, rows), p_out)`` hops
over the topologically ordered op DAG, on ``(B, n)`` bool mask stacks on
the index's device; attribute-level queries (Q3/Q4/Q7/Q8) additionally
thread (row-set x attr-set) terms through the Table-VI attribute maps.

* The batch walkers answer a whole probe batch in one pass over the DAG;
  structured op tensors answer each hop with a take or a scatter, the
  others with one ragged CSR gather for the whole batch.  With
  ``collect_hops`` they also return per-probe :class:`Hop` traces
  (how-provenance, Q5-Q8), read with one host copy per hop.
* :func:`fused_walk_record_masks_batch` answers a linear chain in ONE
  launch of the fused K-hop kernel (:func:`repro_torch.kernels.ops.batched_walk`).
* A term is ``(rows (B, n) bool, attr words (B, nw) int32)`` on the
  index's device.  Each attribute hop contracts the packed attr words
  against the op's memoised attribute plane
  (:meth:`~repro_torch.core.opcat.AttrMap.fwd_plane` / ``bwd_plane``) with
  :func:`~repro_torch.core.provtensor.bitplane_or_reduce`, i.e. one
  ``bitmatmul`` dispatch per live (op, input, term) hop: the kernel for an
  index on the card, its plain version on the CPU.  ``repro`` runs this
  contraction in numpy on the host; the port keeps the rule that the
  operands' device decides.
* :func:`rows_per_probe` turns a ``(B, n)`` mask stack into per-probe row
  lists with one host read for the whole batch.
* :func:`_cells_batch` turns the terms that reach the target into sorted
  ``(n, 2)`` int64 cell lists per probe, from the selected rows alone
  (no ``(B, n_rows, nw)`` accumulator).

The query surface over this layer is :func:`repro_torch.provenance.prov`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import to_device
from repro_torch.core.opcat import AttrMap
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import (
    bitplane_or_reduce,
    pack_bitplane,
    pack_mask,
    unpack_bitplane,
)
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy, span

__all__ = [
    "Hop",
    "forward_record_masks",
    "backward_record_masks",
    "forward_record_masks_batch",
    "backward_record_masks_batch",
    "fused_walk_record_masks_batch",
    "record_masks_terms_batch",
    "attr_propagate_terms_batch",
    "is_probe_batch",
    "rows_per_probe",
    "rows_flat",
]

Term = Tuple[torch.Tensor, torch.Tensor]

# counted once per ``bitplane_or_reduce`` dispatch of the attribute walk,
# inside its ``query.attr_hop`` span
ATTR_HOPS = "attr_hops"


@dataclasses.dataclass(frozen=True)
class Hop:
    """One op traversal — the *how* part of how-provenance (Q5-Q8)."""

    op_id: int
    op_name: str
    category: str
    src_dataset: str
    dst_dataset: str
    n_records: int


# ---------------------------------------------------------------------------
# Probe normalization: single probe vs batch of probes
# ---------------------------------------------------------------------------
def _as_mask(rows, n: int, device) -> torch.Tensor:
    if isinstance(rows, (torch.Tensor, np.ndarray)):
        rows = to_device(rows, device)
        if rows.dtype == torch.bool:
            return rows
        idx = rows.to(torch.int64).reshape(-1)
    else:
        idx = to_device(torch.as_tensor(list(rows), dtype=torch.int64), device)
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[idx] = True
    count_host_copy(device)
    return m


def is_probe_batch(rows) -> bool:
    """A batch is a 2-D mask stack or a non-empty list/tuple of probe sets."""
    if isinstance(rows, (np.ndarray, torch.Tensor)):
        return rows.ndim == 2
    if isinstance(rows, (list, tuple)):
        return len(rows) > 0 and all(
            isinstance(r, (list, tuple, np.ndarray, torch.Tensor, set, frozenset, range))
            for r in rows
        )
    return False


def _as_mask_batch(rows_batch, n: int, device) -> torch.Tensor:
    if isinstance(rows_batch, (torch.Tensor, np.ndarray)) and rows_batch.ndim == 2:
        rows_batch = to_device(rows_batch, device)
        if rows_batch.dtype == torch.bool:
            return rows_batch
        out = torch.zeros((rows_batch.shape[0], n), dtype=torch.bool, device=device)
        out[torch.arange(rows_batch.shape[0], device=device)[:, None],
            rows_batch.to(torch.int64)] = True
        count_host_copy(device)
        return out
    return torch.stack([_as_mask(r, n, device) for r in rows_batch], dim=0)


def _trace(hops: List[List[Hop]], op, src_id: str, dst_id: str,
           contrib: torch.Tensor) -> None:
    """Record a hop for every probe whose contribution through ``op`` is
    non-empty (one host read of the per-probe counts)."""
    count(HOST_SYNCS)
    counts = contrib.sum(dim=1).tolist()
    for b, c in enumerate(counts):
        if c:
            hops[b].append(Hop(op.op_id, op.info.op_name, op.info.category.value,
                               src_id, dst_id, int(c)))


def _trace_terms(hops: List[List[Hop]], op, src_id: str, dst_id: str,
                 new_rm: torch.Tensor, new_aw: torch.Tensor) -> None:
    """Record a hop for every probe whose term survives ``op`` with
    non-empty rows AND attrs (one host read for the whole batch), under a
    ``query.how_trace`` span."""
    with span("query.how_trace"):
        counts = new_rm.sum(dim=1)
        live = (counts > 0) & (new_aw != 0).any(dim=1)
        count(HOST_SYNCS)
        for b, c in enumerate(torch.where(live, counts, 0).tolist()):
            if c:
                hops[b].append(Hop(op.op_id, op.info.op_name, op.info.category.value,
                                   src_id, dst_id, int(c)))


# ---------------------------------------------------------------------------
# Record-level propagation (Q1/Q2 cores)
# ---------------------------------------------------------------------------
def forward_record_masks(
    index: ProvenanceIndex, src: str, rows, collect_hops: bool = False
) -> Tuple[Dict[str, torch.Tensor], List[Hop]]:
    """Propagate ONE row probe from ``src`` to every reachable dataset:
    ``({dataset: (n,) bool}, hops)`` — the batch walker at B = 1 (the hop
    list is empty unless ``collect_hops``)."""
    mask = _as_mask(rows, index.datasets[src].n_rows, index.device)[None, :]
    if not collect_hops:
        return {d: m[0] for d, m in forward_record_masks_batch(index, src, mask).items()}, []
    masks, hops = forward_record_masks_batch(index, src, mask, collect_hops=True)
    return {d: m[0] for d, m in masks.items()}, hops[0]


def backward_record_masks(
    index: ProvenanceIndex, dst: str, rows, collect_hops: bool = False
) -> Tuple[Dict[str, torch.Tensor], List[Hop]]:
    """The backward twin of :func:`forward_record_masks`."""
    mask = _as_mask(rows, index.datasets[dst].n_rows, index.device)[None, :]
    if not collect_hops:
        return {d: m[0] for d, m in backward_record_masks_batch(index, dst, mask).items()}, []
    masks, hops = backward_record_masks_batch(index, dst, mask, collect_hops=True)
    return {d: m[0] for d, m in masks.items()}, hops[0]


def forward_record_masks_batch(
    index: ProvenanceIndex, src: str, rows_batch, collect_hops: bool = False
):
    """Every reachable dataset's ``(B, n_rows)`` bool mask stack, from one
    pass over the DAG: :func:`record_masks_terms_batch` seeded at ``src``.
    With ``collect_hops`` the return is ``(masks, hops)``, ``hops[b]`` being
    probe b's :class:`Hop` trace."""
    stack = _as_mask_batch(rows_batch, index.datasets[src].n_rows, index.device)
    return record_masks_terms_batch(index, {src: stack}, "fwd", collect_hops=collect_hops)


def backward_record_masks_batch(
    index: ProvenanceIndex, dst: str, rows_batch, collect_hops: bool = False
):
    """The backward twin of :func:`forward_record_masks_batch`."""
    stack = _as_mask_batch(rows_batch, index.datasets[dst].n_rows, index.device)
    return record_masks_terms_batch(index, {dst: stack}, "bwd", collect_hops=collect_hops)


# ---------------------------------------------------------------------------
# Fused-kernel record walk
# ---------------------------------------------------------------------------
def fused_walk_record_masks_batch(
    index: ProvenanceIndex,
    src: str,
    dst: str,
    rows_batch,
    direction: str = "fwd",
    max_plane_bytes: int = 256 << 20,
) -> Optional[torch.Tensor]:
    """``(B, n_dst)`` bool answered in ONE kernel launch, or None to fall back.

    The fused :func:`repro_torch.kernels.ops.batched_walk` replaces the
    per-op pass only when the ``src``->``dst`` dataflow is ONE linear chain:
    every op-slot that both receives mass from the upstream end and can
    pass it on to the downstream end must lie on the
    :func:`~repro_torch.core.compose.path_tensors` chain.  Diamonds,
    self-joins and side entrances return None, and so does a chain whose
    square-padded plane stack would exceed ``max_plane_bytes``: the same
    cap as ``repro``'s, computed the same way, so that both packages route
    the same queries to the fused walk (the kernel itself takes per-hop
    dims and pads nothing).

    ``direction="bwd"`` probes ``src`` (the downstream end) and answers at
    ``dst`` through the transposed planes of the reversed chain.
    """
    from repro_torch.core.compose import path_tensors
    from repro_torch.kernels import ops as K

    up, down = (src, dst) if direction == "fwd" else (dst, src)
    if up not in index.datasets or down not in index.datasets:
        return None
    try:
        chain = path_tensors(index, up, down)
    except KeyError:
        return None
    stack = _as_mask_batch(rows_batch, index.datasets[src].n_rows, index.device)
    if not chain:  # src == dst: the seed is the answer
        return stack.clone()

    # linearity audit: one forward and one backward closure over the
    # (topologically ordered) op list find every op-slot carrying mass from
    # `up` toward `down`; the chain is exact iff it covers all of them
    reach = {up}
    for op in index.ops:
        if any(d in reach for d in op.input_ids):
            reach.add(op.output_id)
    feeds = {down}
    for op in reversed(index.ops):
        if op.output_id in feeds:
            feeds.update(op.input_ids)
    relevant = {
        (op.op_id, k)
        for op in index.ops
        for k, in_id in enumerate(op.input_ids)
        if in_id in reach and op.output_id in feeds
    }
    if relevant != {(op.op_id, slot) for op, slot in chain}:
        return None

    n_max = max(max(op.tensor.n_in[slot], op.tensor.n_out) for op, slot in chain)
    if len(chain) * n_max * n_max // 8 > max_plane_bytes:
        return None

    if direction == "fwd":
        planes = [op.tensor.bitplane_fwd(slot) for op, slot in chain]
    else:
        planes = [op.tensor.bitplane_bwd(slot) for op, slot in reversed(chain)]
    out_bits, _counts = K.batched_walk(pack_bitplane(stack), planes)
    return unpack_bitplane(out_bits, index.datasets[dst].n_rows)


def _ops_from_entries(index: ProvenanceIndex, entries, direction: str):
    """Ops reachable from ANY entry dataset, in traversal order.

    Op registration order is topological, so sorting the union by ``op_id``
    (descending for ``"bwd"``) reproduces the single-entry walk order
    exactly."""
    by_id = {}
    for ds in entries:
        ops = (index.downstream_ops(ds) if direction == "fwd"
               else index.upstream_ops(ds))
        for op in ops:
            by_id[op.op_id] = op
    out = [by_id[i] for i in sorted(by_id)]
    if direction == "bwd":
        out.reverse()
    return out


def record_masks_terms_batch(
    index: ProvenanceIndex, entry_masks, direction: str,
    collect_hops: bool = False,
):
    """Record propagation seeded at ARBITRARY datasets (federated segments).

    ``entry_masks`` maps dataset id -> ``(B, n_rows)`` bool probe stacks.
    One pass over every op reachable from any entry, in op order (reversed
    for ``"bwd"``); :func:`forward_record_masks_batch` and
    :func:`backward_record_masks_batch` are its one-seed calls.  Returns
    ``(masks, hops)`` with ``collect_hops``, else ``masks``."""
    dev = index.device
    masks: Dict[str, torch.Tensor] = {
        ds: torch.as_tensor(m).to(device=dev, dtype=torch.bool)
        for ds, m in entry_masks.items()
    }
    if not masks:
        raise ValueError("record_masks_terms_batch needs at least one entry")
    B = next(iter(masks.values())).shape[0]
    hops: List[List[Hop]] = [[] for _ in range(B)]
    for op in _ops_from_entries(index, list(masks), direction):
        if direction == "fwd":
            out_mask = masks.get(op.output_id)
            if out_mask is None:
                out_mask = torch.zeros((B, op.tensor.n_out), dtype=torch.bool, device=dev)
            for k, in_id in enumerate(op.input_ids):
                if in_id in masks and _any(masks[in_id]):
                    contrib = op.tensor.forward_mask_batch(k, masks[in_id])
                    if collect_hops:
                        _trace(hops, op, in_id, op.output_id, contrib)
                    out_mask = out_mask | contrib
            masks[op.output_id] = out_mask
        else:
            if op.output_id not in masks or not _any(masks[op.output_id]):
                continue
            for k, in_id in enumerate(op.input_ids):
                contrib = op.tensor.backward_mask_batch(k, masks[op.output_id])
                if collect_hops:
                    _trace(hops, op, op.output_id, in_id, contrib)
                prev = masks.get(in_id)
                masks[in_id] = contrib if prev is None else prev | contrib
    if collect_hops:
        return masks, hops
    return masks


# ---------------------------------------------------------------------------
# Attribute maps (Table VI bitsets -> per-op attr propagation).  An attr
# mask is PACKED int32 words; one op hop is a select-OR contraction of the
# packed mask against the op's memoised attribute plane.
# ---------------------------------------------------------------------------
def _attrs_forward(amap: AttrMap, attrs: torch.Tensor, n_out_attrs: int) -> torch.Tensor:
    """Map an input-attr mask to the output-attr mask through one op input."""
    attrs = torch.as_tensor(attrs).to(torch.bool)
    plane = amap.fwd_plane(attrs.shape[0], n_out_attrs, attrs.device)
    words = bitplane_or_reduce(pack_mask(attrs)[None, :], plane, attrs.shape[0])
    return unpack_bitplane(words, n_out_attrs)[0]


def _attrs_backward(amap: AttrMap, attrs: torch.Tensor, n_in_attrs: int) -> torch.Tensor:
    attrs = torch.as_tensor(attrs).to(torch.bool)
    plane = amap.bwd_plane(n_in_attrs, attrs.shape[0], attrs.device)
    words = bitplane_or_reduce(pack_mask(attrs)[None, :], plane, attrs.shape[0])
    return unpack_bitplane(words, n_in_attrs)[0]


def _any(a: torch.Tensor) -> bool:
    """``a.any()``, read on the host."""
    count(HOST_SYNCS)
    return bool(a.any())


def _any2(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a.any() and b.any()`` in one host read."""
    count(HOST_SYNCS)
    return bool(torch.stack([a.any(), (b != 0).any()]).all())


# ---------------------------------------------------------------------------
# Attribute-level queries (Q3/Q4/Q7/Q8): (row-mask, packed-attr-words) terms
# ---------------------------------------------------------------------------
def _attr_propagate(
    index: ProvenanceIndex, start: str, rows, attrs, direction: str,
    collect_hops: bool = False,
):
    """Single-probe term propagation, ``(terms, hops)`` with terms of
    ``((n,) bool, (nw,) int32)``: :func:`_attr_propagate_batch` at B = 1."""
    dev = index.device
    ds0 = index.datasets[start]
    out = _attr_propagate_batch(
        index, start, _as_mask(rows, ds0.n_rows, dev)[None, :],
        _as_mask(attrs, ds0.n_cols, dev)[None, :], direction, collect_hops=collect_hops)
    terms = {d: [(rm[0], aw[0]) for rm, aw in ts] for d, ts in out[0].items()}
    return terms, out[2][0] if collect_hops else []


def attr_propagate_terms_batch(
    index: ProvenanceIndex, entry_terms, direction: str,
    collect_hops: bool = False,
):
    """Term propagation seeded at ARBITRARY datasets (federated segments).

    ``entry_terms`` maps dataset id -> list of ``((B, n_rows) bool, (B, nw)
    int32)`` packed terms on the index's device.  Per op the semantics are
    those of :func:`_attr_propagate_batch` (a single-entry seed reproduces
    it term for term), over every op reachable from ANY entry.  Each live
    (op, input, term) hop is one ``bitmatmul`` dispatch, under a
    ``query.attr_hop`` span on the index's device that counts
    :data:`ATTR_HOPS` (the row-mask move and the contraction; off, one
    module-global check a hop).

    Returns ``(terms, B, hops)`` with ``collect_hops``, else ``(terms, B)``.
    """
    dev = index.device
    terms: Dict[str, List[Term]] = {ds: list(ts) for ds, ts in entry_terms.items() if ts}
    if not terms:
        raise ValueError("attr_propagate_terms_batch needs at least one "
                         "non-empty entry term list")
    B = next(iter(terms.values()))[0][0].shape[0]
    hops: List[List[Hop]] = [[] for _ in range(B)]
    for op in _ops_from_entries(index, list(terms), direction):
        out_ds = index.datasets[op.output_id]
        if direction == "fwd":
            for k, in_id in enumerate(op.input_ids):
                in_ds = index.datasets[in_id]
                plane = op.info.attr_maps[k].fwd_plane(in_ds.n_cols, out_ds.n_cols, dev)
                for (rm, aw) in terms.get(in_id, []):
                    if not _any(rm):
                        continue
                    with span("query.attr_hop", dev) as sp:
                        new_rm = op.tensor.forward_mask_batch(k, rm)
                        new_aw = bitplane_or_reduce(aw, plane, in_ds.n_cols)
                        if sp is not None:
                            count(ATTR_HOPS)
                    if _any2(new_rm, new_aw):
                        terms.setdefault(op.output_id, []).append((new_rm, new_aw))
                        if collect_hops:
                            _trace_terms(hops, op, in_id, op.output_id, new_rm, new_aw)
        else:
            for (rm, aw) in terms.get(op.output_id, []):
                if not _any(rm):
                    continue
                for k, in_id in enumerate(op.input_ids):
                    in_ds = index.datasets[in_id]
                    plane = op.info.attr_maps[k].bwd_plane(in_ds.n_cols, out_ds.n_cols, dev)
                    with span("query.attr_hop", dev) as sp:
                        new_rm = op.tensor.backward_mask_batch(k, rm)
                        new_aw = bitplane_or_reduce(aw, plane, out_ds.n_cols)
                        if sp is not None:
                            count(ATTR_HOPS)
                    if _any2(new_rm, new_aw):
                        terms.setdefault(in_id, []).append((new_rm, new_aw))
                        if collect_hops:
                            _trace_terms(hops, op, op.output_id, in_id, new_rm, new_aw)
    if collect_hops:
        return terms, B, hops
    return terms, B


def _attr_propagate_batch(
    index: ProvenanceIndex, start: str, rows_batch, attrs_batch, direction: str,
    collect_hops: bool = False,
):
    """Batched term propagation from one dataset: ``rows_batch`` is a probe
    batch; ``attrs_batch`` a batch of attr sets or one set broadcast over
    it.  A hop is recorded for probe b iff probe b's term survives the op
    with non-empty row AND attr masks, as in :func:`_attr_propagate`."""
    dev = index.device
    ds0 = index.datasets[start]
    rm0 = _as_mask_batch(rows_batch, ds0.n_rows, dev)
    B = rm0.shape[0]
    if is_probe_batch(attrs_batch):
        am0 = _as_mask_batch(attrs_batch, ds0.n_cols, dev)
    else:
        am0 = _as_mask(attrs_batch, ds0.n_cols, dev)[None, :].expand(B, ds0.n_cols)
    entry = {start: [(rm0, pack_bitplane(am0.contiguous()))]}
    return attr_propagate_terms_batch(index, entry, direction, collect_hops=collect_hops)


def rows_per_probe(mask_stack: torch.Tensor) -> List[torch.Tensor]:
    """Each probe's row indices from a ``(B, n)`` bool mask stack: int64,
    ascending, on the stack's device, as ``torch.nonzero`` gives them row
    by row, with ONE host read for the whole batch: the views of
    :func:`rows_flat`'s buffer split by its counts."""
    flat, counts = rows_flat(mask_stack)
    if len(counts) <= 1:
        return [flat] if counts else []
    return list(torch.split(flat, counts))


def rows_flat(mask_stack: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """Every probe's row indices from a ``(B, n)`` bool mask stack as one
    int64 buffer, probe after probe, each probe's rows ascending, and the
    per-probe counts on the host, with ONE host read for the whole batch.

    The per-probe counts are reduced on the device and read with one
    ``.tolist()``; their sum sizes a ``nonzero_static`` over the stack,
    which needs no read.  A single probe takes one ``nonzero`` (one read
    either way, and no reduction)."""
    B = mask_stack.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.int64, device=mask_stack.device), []
    count(HOST_SYNCS, 1)
    if B == 1:
        flat = torch.nonzero(mask_stack[0]).reshape(-1)
        return flat, [len(flat)]
    counts = _row_counts(mask_stack).tolist()
    return torch.nonzero_static(mask_stack, size=sum(counts))[:, 1].contiguous(), counts


def _row_counts(mask_stack: torch.Tensor) -> torch.Tensor:
    """The set entries of each row of a ``(B, n)`` bool stack, on its
    device.  A bool ``sum`` first copies the stack to int64, eight times
    its bytes; byte sums over runs of 255 and over the shorter tail, which
    a uint8 holds, read the stack where it lies and leave ``n / 255``
    partial counts a row."""
    B, n = mask_stack.shape
    m8 = mask_stack.view(torch.uint8)
    k = n - n % 255
    runs = m8[:, :k].reshape(B, -1, 255).sum(2, dtype=torch.uint8)
    return runs.sum(1) + m8[:, k:].sum(1, dtype=torch.uint8)


def _cells_batch(terms: List[Term], B: int, n_rows: int, n_cols: int,
                 device) -> List[torch.Tensor]:
    """Per probe, the union of its (rows x attrs) products -> a sorted
    unique ``(n, 2)`` int64 cell list on ``device``, row-major as
    ``np.argwhere`` gives it.

    Built from the selected rows alone: each term's set (probe, row) pairs
    take that probe's attr words, are unpacked to cells, and the cells of
    all terms are merged by one sort of their int64 keys
    ``(b * n_rows + row) * n_cols + col``; one host read splits them per
    probe."""
    keys = []
    for rm, aw in terms:
        count(HOST_SYNCS, 2)
        bs, rs = torch.nonzero(rm, as_tuple=True)
        p, cs = torch.nonzero(unpack_bitplane(aw[bs], n_cols), as_tuple=True)
        keys.append((bs[p] * n_rows + rs[p]) * n_cols + cs)
    if not keys:
        empty = torch.zeros((0, 2), dtype=torch.int64, device=device)
        return [empty] * B
    key = torch.unique(torch.cat(keys))
    per_probe, nc = max(n_rows * n_cols, 1), max(n_cols, 1)
    rest = key % per_probe
    cells = torch.stack([rest // nc, rest % nc], dim=1)
    # the unique's size, the bincount's least and largest key, the counts
    count(HOST_SYNCS, 4 if key.numel() else 2)
    counts = torch.bincount(key // per_probe, minlength=B).tolist()
    return list(torch.split(cells, counts))


def _cells(terms: List[Term], n_rows: int, n_cols: int, device) -> torch.Tensor:
    """Single-probe :func:`_cells_batch` over ``((n,) bool, (nw,) int32)`` terms."""
    return _cells_batch([(rm[None, :], aw[None, :]) for rm, aw in terms],
                        1, n_rows, n_cols, device)[0]


# ---------------------------------------------------------------------------
# Q10 helper: the default meeting dataset
# ---------------------------------------------------------------------------
def _pick_via(index: ProvenanceIndex, d1: str, d2: str, fwd_masks, b=None) -> Optional[str]:
    """The naive default: the last forward-reached dataset that d2 also feeds."""
    candidates = [
        d for d, m in fwd_masks.items()
        if d != d1 and _any(m[b] if b is not None else m)
        and index.path_exists(d2, d)
    ]
    return candidates[-1] if candidates else None
