"""Einstein-summation composition of provenance chains (paper §IV).

For whole-dataset lineage (the paper's fairness/consent audits), chaining
``slice -> project`` per record is wasteful; the paper instead contracts the
tensors of consecutive operations:

    T_1 ⊗ T_2 ⊗ ... ⊗ T_n   (contracting out_dim(T_j) = in_dim(T_{j+1}))

Over binary relations this is the (OR, AND) boolean semiring.  Three
representations compose, each on the device its operands lie on:

* packed int32 relation bitplanes through :func:`compose_pair`, i.e.
  :func:`repro_torch.kernels.ops.bitmatmul` (the hand-written kernel for
  CUDA operands, its plain version for CPU ones);
* torch sparse CSR (float32 ones, **int32** ``crow_indices`` /
  ``col_indices``, so that byte accounting matches ``repro``'s scipy CSR)
  through :func:`compose_pair_csr`: a sparse product thresholded ``> 0``;
* structured gathers (int32 destination -> source maps, -1 = no link)
  through :func:`compose_gather`: one take, no product at all.

``plan_chain`` does the classic matrix-chain dynamic program on relation
dims; :func:`compose_chain` plans with the nnz-aware DP of
:mod:`repro_torch.core.costmodel`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.pipeline import OpRecord, ProvenanceIndex
from repro_torch.core.provtensor import (
    CSR,
    ProvTensor,
    SlotIdentity,
    pack_bitplane,
    unpack_bitplane,
)
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.kernels import ops as K

__all__ = [
    "path_tensors",
    "op_bitplane",
    "op_csr",
    "op_gather",
    "binary_csr",
    "csr_from_pairs",
    "csr_pairs",
    "compose_pair",
    "compose_pair_csr",
    "compose_gather",
    "chain_gather",
    "extend_tail",
    "extend_tail_csr",
    "extend_tail_bitplane",
    "compose_chain",
    "plan_chain",
    "dataset_lineage",
]


def path_tensors(index: ProvenanceIndex, src: str, dst: str) -> List[Tuple[OpRecord, int]]:
    """The op chain linking ``src`` to ``dst``: [(op, input_slot), ...].

    Follows the (unique-producer) dataflow backward from ``dst`` and keeps
    the ops on a path that reaches ``src``; for multi-input ops the slot
    records WHICH input lies on the path.  The reachable-from-``src`` set is
    computed once up front.
    """
    reach = {src}
    for op in index.ops:
        if any(d in reach for d in op.input_ids):
            reach.add(op.output_id)
    chain: List[Tuple[OpRecord, int]] = []
    cur = dst
    while cur != src:
        if cur not in index.producer:
            raise KeyError(f"no dataflow path {src} -> {dst} (stuck at {cur})")
        op = index.ops[index.producer[cur]]
        slot = None
        for k, in_id in enumerate(op.input_ids):
            if in_id in reach:
                slot = k
                break
        if slot is None:
            raise KeyError(f"no dataflow path {src} -> {dst} (op {op.info.op_name})")
        chain.append((op, slot))
        cur = op.input_ids[slot]
    return list(reversed(chain))


# ---------------------------------------------------------------------------
# torch sparse CSR relations (the sparse backend)
# ---------------------------------------------------------------------------
def binary_csr(crow: torch.Tensor, col: torch.Tensor, n_rows: int,
               n_cols: int) -> torch.Tensor:
    """A binary relation as torch sparse CSR: int32 indices, float32 ones.

    float32 values keep the boolean semiring exact under composition: path
    counts are sums of positives, so ``> 0`` never misclassifies."""
    col = col.to(torch.int32)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), col, torch.ones(col.shape[0], dtype=torch.float32,
                                              device=col.device),
        size=(n_rows, n_cols), check_invariants=False)


def csr_from_pairs(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                   n_cols: int) -> torch.Tensor:
    """Distinct (row, col) links -> binary CSR, sorted by row then column."""
    c = CSR.from_pairs(rows, cols, n_rows, n_cols)
    return binary_csr(c.row_ptr, c.col_idx, n_rows, n_cols)


def csr_pairs(rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (row, col) int64 links of a CSR relation, in storage order."""
    crow = rel.crow_indices().to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(rel.shape[0], dtype=torch.int64, device=crow.device),
        torch.diff(crow), output_size=rel.col_indices().shape[0])
    return rows, rel.col_indices().to(torch.int64)


def op_bitplane(t: ProvTensor, slot: int) -> torch.Tensor:
    """R[i, o] forward bitplane of one op tensor for one input slot
    (memoized on the tensor — the hop-cache recomposes from these)."""
    return t.bitplane_fwd(slot)


def op_csr(t: ProvTensor, slot: int) -> torch.Tensor:
    """The same forward relation as torch sparse CSR — a view over the
    tensor's bidirectional index (shares row_ptr/col_idx)."""
    c = t.fwd(slot)
    return binary_csr(c.row_ptr, c.col_idx, c.n_rows, c.n_cols)


def compose_pair_csr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(OR, AND)-compose two CSR relations: sparse product, then clamp the
    path counts back to the binary relation."""
    c = a @ b
    return binary_csr(c.crow_indices(), c.col_indices(), c.shape[0], c.shape[1])


def op_gather(t: ProvTensor, slot: int) -> Optional[torch.Tensor]:
    """The op relation's implicit destination -> source gather (int32
    ``(n_out,)``, -1 = no link) when the slot is structured, else None."""
    return t.slot_gather(slot)


def compose_gather(g_pre: torch.Tensor, g_step: torch.Tensor) -> torch.Tensor:
    """Closed-form ``prefix ∘ step`` over gather relations: ONE take.

    ``g_pre`` maps mid -> src, ``g_step`` maps dst -> mid; the composition
    maps dst -> src, propagating the -1 "no link" sentinel through both
    hops."""
    valid = g_step >= 0
    if g_pre.numel() == 0:  # an empty mid set links nothing
        return torch.full_like(g_step, -1, dtype=torch.int32)
    picked = g_pre[torch.where(valid, g_step, torch.zeros_like(g_step)).long()]
    return torch.where(valid, picked, torch.full_like(picked, -1)).to(torch.int32)


def chain_gather(chain: Sequence[Tuple[object, int]]) -> Optional[torch.Tensor]:
    """Fold a whole op chain of structured slots into one dst -> src gather;
    None when any hop lacks structure (a multi-parent raw-COO relation).
    Identity hops are eliminated outright."""
    acc: Optional[torch.Tensor] = None  # None = identity so far
    for op, slot in chain:
        s = op.tensor.slot_structure(slot)
        if s is None:
            return None
        if isinstance(s, SlotIdentity):
            continue
        g = op.tensor.slot_gather(slot)
        acc = g if acc is None else compose_gather(acc, g)
    if acc is None and chain:
        t = chain[-1][0].tensor
        acc = torch.arange(t.n_out, dtype=torch.int32, device=t.device)
    return acc


def extend_tail_csr(rel: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form ``prefix ∘ gather-step`` for a CSR prefix: a column
    gather, NOT a sparse product.

    ``rel`` is the composed (n_src x n_mid) forward relation; ``g`` maps
    dst -> mid (int32 (n_dst,), -1 = no link).  Every dst column of the
    result is exactly one mid column of the prefix (or empty):
    ``out[:, d] = rel[:, g[d]]``, one ragged gather over the prefix's
    columns."""
    g = g.to(torch.int64).reshape(-1)
    n_src = rel.shape[0]
    n_mid = rel.shape[1]
    n_dst = g.shape[0]
    rows, cols = csr_pairs(rel)
    by_col = CSR.from_pairs(cols, rows, n_mid, n_src)      # the prefix's columns
    count(HOST_SYNCS, 2)    # the nonzero, the total
    dst = torch.nonzero(g >= 0).reshape(-1)
    mids = g[dst]
    starts = by_col.row_ptr[mids].to(torch.int64)
    degs = by_col.row_ptr[mids + 1].to(torch.int64) - starts
    total = int(degs.sum())
    offsets = torch.cumsum(degs, dim=0) - degs
    flat = (torch.repeat_interleave(starts - offsets, degs, output_size=total)
            + torch.arange(total, dtype=torch.int64, device=g.device))
    out_rows = by_col.col_idx[flat].to(torch.int64)
    out_cols = torch.repeat_interleave(dst, degs, output_size=total)
    return csr_from_pairs(out_rows, out_cols, n_src, n_dst)


def extend_tail_bitplane(plane: torch.Tensor, g: torch.Tensor, n_mid: int) -> torch.Tensor:
    """Closed-form ``prefix ∘ gather-step`` for a packed-bitplane prefix:
    a column take through the dst -> mid gather, blocked so the transient
    dense unpack stays ~4 MB regardless of relation size."""
    g = g.to(torch.int64).reshape(-1)
    n_src = plane.shape[0]
    n_dst = g.shape[0]
    valid = g >= 0
    safe = torch.where(valid, g, torch.zeros_like(g))
    out = torch.empty((n_src, (n_dst + 31) // 32), dtype=torch.int32, device=plane.device)
    block = max(1, (4 << 20) // max(n_mid + n_dst, 1))
    for lo in range(0, max(n_src, 1), block):
        hi = min(lo + block, n_src)
        if hi <= lo:
            break
        dense = unpack_bitplane(plane[lo:hi], n_mid)
        out[lo:hi] = pack_bitplane(dense[:, safe] & valid[None, :])
    return out


def extend_tail(rel, g: torch.Tensor, backend: str, n_mid: Optional[int] = None):
    """Dispatch the closed-form one-step extension by prefix backend
    (``"csr"`` | ``"bitplane"``); structured prefixes use
    :func:`compose_gather` directly and never come through here."""
    if backend == "csr":
        return extend_tail_csr(rel, g)
    if backend == "bitplane":
        if n_mid is None:
            raise ValueError("bitplane extension needs n_mid")
        return extend_tail_bitplane(rel, g, n_mid)
    raise ValueError(f"unknown backend {backend!r}")


def compose_pair(a_bits: torch.Tensor, b_bits: torch.Tensor, n_mid: int) -> torch.Tensor:
    """(OR, AND)-compose packed relations A (R x mid) . B (mid x C) ->
    (R x C) packed, through :func:`repro_torch.kernels.ops.bitmatmul`.
    ``n_mid`` (the rows of B) is the contraction, which the entry checks."""
    return K.bitmatmul(a_bits, b_bits)


def plan_chain(dims: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """DIMS-ONLY matrix-chain-order DP.  Input is relation shapes
    [(r0, c0), (r1, c1), ...] with c_j == r_{j+1}; returns the
    multiplication order as (i, j) merges over a working list."""
    n = len(dims)
    if n <= 1:
        return []
    p = [dims[0][0]] + [d[1] for d in dims]  # dimension vector
    INF = float("inf")
    cost = [[0.0] * n for _ in range(n)]
    split = [[0] * n for _ in range(n)]
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            cost[i][j] = INF
            for k in range(i, j):
                c = cost[i][k] + cost[k + 1][j] + p[i] * p[k + 1] * p[j + 1]
                if c < cost[i][j]:
                    cost[i][j] = c
                    split[i][j] = k
    order: List[Tuple[int, int]] = []

    def emit(i: int, j: int) -> None:
        if i == j:
            return
        k = split[i][j]
        emit(i, k)
        emit(k + 1, j)
        order.append((i, k))  # merge [i..k] with [k+1..j]

    emit(0, n - 1)
    return order


def compose_chain(index: ProvenanceIndex, src: str, dst: str,
                  optimize: bool = True) -> torch.Tensor:
    """Packed (|src| x ceil(|dst|/32)) relation bitplane for the whole path,
    on the index's device.  ``optimize=True`` applies the matrix-chain DP
    (associativity); otherwise left-to-right accumulation (the paper's
    literal chain)."""
    chain = path_tensors(index, src, dst)
    dev = index.device
    if not chain:
        n = index.datasets[src].n_rows
        return pack_bitplane(torch.eye(n, dtype=torch.bool, device=dev))
    g = chain_gather(chain)
    if g is not None:
        # the whole path is structured: fold the gathers closed-form and
        # expand to the packed plane once
        n_src = index.datasets[src].n_rows
        dense = torch.zeros((n_src, g.shape[0]), dtype=torch.bool, device=dev)
        count(HOST_SYNCS)
        dst_rows = torch.nonzero(g >= 0).reshape(-1)
        dense[g[dst_rows].long(), dst_rows] = True
        count_host_copy(dev)
        return pack_bitplane(dense)
    planes = [op_bitplane(op.tensor, slot) for op, slot in chain]
    rowdims = [op.tensor.n_in[slot] for op, slot in chain]
    coldims = [op.tensor.n_out for op, _ in chain]

    if not optimize or len(planes) == 1:
        acc = planes[0]
        for j in range(1, len(planes)):
            acc = compose_pair(acc, planes[j], rowdims[j])
        return acc

    # stats-propagating chain DP priced in the bitplane backend, whose word
    # ops scale with dims (it reduces to the classic dims DP)
    from repro_torch.core.costmodel import RelStats, plan_chain_stats

    stats = [RelStats.from_slot(op.tensor, slot) for op, slot in chain]
    order = plan_chain_stats(stats, backend="bitplane")
    work: List[Optional[Tuple[torch.Tensor, int, int]]] = [
        (planes[i], rowdims[i], coldims[i]) for i in range(len(planes))
    ]
    for (i, _k) in order:
        # merge segment starting at i with the next live segment to its right
        j = i + 1
        while work[j] is None:
            j += 1
        a, ra, ca = work[i]
        b, rb, cb = work[j]
        work[i] = (compose_pair(a, b, ca), ra, cb)
        work[j] = None
    return next(w for w in work if w is not None)[0]


def dataset_lineage(index: ProvenanceIndex, src: str, dst: str) -> torch.Tensor:
    """Dense bool (|src|, |dst|) lineage relation for the whole dataset —
    the paper's einsum use case (fairness / consent audits)."""
    return unpack_bitplane(compose_chain(index, src, dst), index.datasets[dst].n_rows)
