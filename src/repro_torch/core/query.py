"""Record-level provenance queries (paper Section IV, Table VII: Q1/Q2, Q5/Q6).

The physical layer under :mod:`repro_torch.provenance`: record-level
queries chain ``project(slice(T, p_in, rows), p_out)`` hops over the
topologically ordered op DAG, on ``(B, n)`` bool mask stacks on the
index's device.

* The batch walkers answer a whole probe batch in one pass over the DAG;
  structured op tensors answer each hop with a take or a scatter, the
  others with one ragged CSR gather for the whole batch.  With
  ``collect_hops`` they also return per-probe :class:`Hop` traces
  (how-provenance, Q5/Q6).
* :func:`fused_walk_record_masks_batch` answers a linear chain in ONE
  launch of the fused K-hop kernel (:func:`repro_torch.kernels.ops.batched_walk`).

The attribute-level walkers (Q3/Q4/Q7/Q8) and the legacy ``q*`` shims
belong to a later slice (ROADMAP A5b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import pack_bitplane, unpack_bitplane

__all__ = [
    "Hop",
    "forward_record_masks_batch",
    "backward_record_masks_batch",
    "fused_walk_record_masks_batch",
    "is_probe_batch",
]


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
        rows = torch.as_tensor(rows).to(device)
        if rows.dtype == torch.bool:
            return rows
        idx = rows.to(torch.int64).reshape(-1)
    else:
        idx = torch.as_tensor(list(rows), dtype=torch.int64, device=device)
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[idx] = True
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
        rows_batch = torch.as_tensor(rows_batch).to(device)
        if rows_batch.dtype == torch.bool:
            return rows_batch
        out = torch.zeros((rows_batch.shape[0], n), dtype=torch.bool, device=device)
        out[torch.arange(rows_batch.shape[0], device=device)[:, None],
            rows_batch.to(torch.int64)] = True
        return out
    return torch.stack([_as_mask(r, n, device) for r in rows_batch], dim=0)


def _trace(hops: List[List[Hop]], op, src_id: str, dst_id: str,
           contrib: torch.Tensor) -> None:
    """Record a hop for every probe whose contribution through ``op`` is
    non-empty (one host read of the per-probe counts)."""
    counts = contrib.sum(dim=1).tolist()
    for b, c in enumerate(counts):
        if c:
            hops[b].append(Hop(op.op_id, op.info.op_name, op.info.category.value,
                               src_id, dst_id, int(c)))


# ---------------------------------------------------------------------------
# Record-level propagation (Q1/Q2 cores)
# ---------------------------------------------------------------------------
def forward_record_masks_batch(
    index: ProvenanceIndex, src: str, rows_batch, collect_hops: bool = False
):
    """Every reachable dataset's ``(B, n_rows)`` bool mask stack, from one
    pass over the DAG.  With ``collect_hops`` the return is ``(masks,
    hops)``, ``hops[b]`` being probe b's :class:`Hop` trace."""
    dev = index.device
    stack = _as_mask_batch(rows_batch, index.datasets[src].n_rows, dev)
    masks: Dict[str, torch.Tensor] = {src: stack}
    B = stack.shape[0]
    hops: List[List[Hop]] = [[] for _ in range(B)]
    for op in index.downstream_ops(src):
        out_mask = masks.get(op.output_id)
        if out_mask is None:
            out_mask = torch.zeros((B, op.tensor.n_out), dtype=torch.bool, device=dev)
        for k, in_id in enumerate(op.input_ids):
            if in_id in masks and bool(masks[in_id].any()):
                contrib = op.tensor.forward_mask_batch(k, masks[in_id])
                if collect_hops:
                    _trace(hops, op, in_id, op.output_id, contrib)
                out_mask = out_mask | contrib
        masks[op.output_id] = out_mask
    if collect_hops:
        return masks, hops
    return masks


def backward_record_masks_batch(
    index: ProvenanceIndex, dst: str, rows_batch, collect_hops: bool = False
):
    """The backward twin of :func:`forward_record_masks_batch`."""
    dev = index.device
    stack = _as_mask_batch(rows_batch, index.datasets[dst].n_rows, dev)
    masks: Dict[str, torch.Tensor] = {dst: stack}
    B = stack.shape[0]
    hops: List[List[Hop]] = [[] for _ in range(B)]
    for op in reversed(index.upstream_ops(dst)):
        if op.output_id not in masks or not bool(masks[op.output_id].any()):
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


# ---------------------------------------------------------------------------
# Q10 helper: the default meeting dataset
# ---------------------------------------------------------------------------
def _pick_via(index: ProvenanceIndex, d1: str, d2: str, fwd_masks, b=None) -> Optional[str]:
    """The naive default: the last forward-reached dataset that d2 also feeds."""
    candidates = [
        d for d, m in fwd_masks.items()
        if d != d1 and bool(m[b].any() if b is not None else m.any())
        and index.path_exists(d2, d)
    ]
    return candidates[-1] if candidates else None
