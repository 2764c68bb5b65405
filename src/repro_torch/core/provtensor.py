"""Sparse binary provenance tensors (the paper's Section III), on a device.

A :class:`ProvTensor` encodes the why-provenance of ONE data-processing
operation: an order-(k+1) binary tensor ``T(o, i_1..i_k) = 1`` iff output
record ``o`` derives from the tuple of input records ``(i_1..i_k)``.

Two storage regimes, as in ``repro``:

* **Structured (implicit)** — the capture default.  A transformation or
  vertical op is the identity (:class:`SlotIdentity`, no array at all); a
  horizontal reduction or augmentation, and each side of a join, is one
  int32 gather (:class:`SlotGather`, ``-1`` = no link); append's two blocks
  are two offsets (:class:`SlotRange`).
* **Explicit COO** — ``(nnz, 1+k)`` int32 tuples ``(out, in_1, .., in_k)``.

Every row-indexed array (gathers, COO, CSR ``row_ptr``/``col_idx``, packed
bitplanes, probe mask stacks) lies on the tensor's device.  The derived
mirrors — bidirectional CSR per input slot and packed int32 relation
bitplanes (bit j of word w = column 32w + j) — are built on demand on that
device and are byte-identical to ``repro``'s after
``.numpy().view(np.uint32)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import (
    pack_bits,
    popcount32,
    unpack_bits,
    wrap_int32,
)

__all__ = [
    "CSR",
    "ProvTensor",
    "SlotIdentity",
    "SlotGather",
    "SlotRange",
    "shard_ranges",
    "identity_tensor",
    "hreduce_tensor",
    "haugment_tensor",
    "join_tensor",
    "append_tensor",
    "pack_pairs",
    "pack_bitplane",
    "unpack_bitplane",
    "pack_mask",
    "unpack_mask",
    "bitplane_or_reduce",
    "bitplane_popcount",
]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _ragged_positions(starts: torch.Tensor, degs: torch.Tensor) -> torch.Tensor:
    """Flat positions ``starts[i] + [0, degs[i])`` for every i, in order —
    the ``np.repeat`` / ``arange`` expansion of a ragged CSR gather."""
    count(HOST_SYNCS)
    total = int(degs.sum())
    offsets = torch.cumsum(degs, dim=0) - degs
    return (torch.repeat_interleave(starts - offsets, degs, output_size=total)
            + torch.arange(total, dtype=starts.dtype, device=starts.device))


# ---------------------------------------------------------------------------
# CSR half of the bidirectional index
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse rows: ``row_ptr`` (n_rows+1,), ``col_idx`` (nnz,),
    int32 on the index's device."""

    n_rows: int
    n_cols: int
    row_ptr: torch.Tensor
    col_idx: torch.Tensor

    @staticmethod
    def from_pairs(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                   n_cols: int) -> "CSR":
        """Sorted by row, then column (``repro``'s ``np.lexsort``), through
        one sort of the int64 key ``row << 32 | col``."""
        rows = rows.to(torch.int64)
        cols = cols.to(torch.int64)
        keep = (rows >= 0) & (cols >= 0)
        key, _ = torch.sort((rows[keep] << 32) | cols[keep])
        rows = key >> 32
        # two boolean indexes, the bincount's least and largest row
        count(HOST_SYNCS, 4 if key.numel() else 2)
        counts = torch.bincount(rows, minlength=n_rows)
        row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=key.device)
        row_ptr[1:] = torch.cumsum(counts, dim=0)
        return CSR(n_rows=n_rows, n_cols=n_cols, row_ptr=row_ptr,
                   col_idx=(key & 0xFFFFFFFF).to(torch.int32))

    def neighbors(self, q: int) -> torch.Tensor:
        """Row ``q``'s column indices (int32), in order."""
        return self.col_idx[int(self.row_ptr[q]): int(self.row_ptr[q + 1])]

    def _valid_queries(self, qs) -> torch.Tensor:
        qs = torch.as_tensor(qs, dtype=torch.int64, device=self.row_ptr.device).reshape(-1)
        return qs[(qs >= 0) & (qs < self.n_rows)]

    def batch_neighbors(self, qs, max_deg: Optional[int] = None) -> torch.Tensor:
        """Padded (-1) batched probe: ``(len(qs), max_deg)`` int32."""
        qs = torch.as_tensor(qs, dtype=torch.int64, device=self.row_ptr.device).reshape(-1)
        starts = self.row_ptr[qs].to(torch.int64)
        degs = self.row_ptr[qs + 1].to(torch.int64) - starts
        if max_deg is None and len(degs):
            count(HOST_SYNCS)
            max_deg = int(degs.max())
        elif max_deg is None:
            max_deg = 0
        max_deg = max(max_deg, 1)
        lane = torch.arange(max_deg, dtype=torch.int64, device=qs.device)[None, :]
        live = lane < degs[:, None]
        pos = torch.where(live, starts[:, None] + lane, torch.zeros_like(lane))
        vals = self.col_idx[pos] if self.col_idx.numel() else \
            torch.zeros_like(pos, dtype=torch.int32)
        return torch.where(live, vals, torch.full_like(vals, -1)).to(torch.int32)

    def gather_rows(self, qs) -> torch.Tensor:
        """Sorted-unique neighbours of a query-row set, int64.  Out-of-range
        and negative query rows are ignored."""
        qs = self._valid_queries(qs)
        starts = self.row_ptr[qs].to(torch.int64)
        degs = self.row_ptr[qs + 1].to(torch.int64) - starts
        return torch.unique(self.col_idx[_ragged_positions(starts, degs)]).to(torch.int64)

    def neighbor_mask(self, qs) -> torch.Tensor:
        """OR of neighbour indicator rows for a query set -> bool (n_cols,)."""
        mask = torch.zeros(self.n_cols, dtype=torch.bool, device=self.row_ptr.device)
        qs = self._valid_queries(qs)
        starts = self.row_ptr[qs].to(torch.int64)
        degs = self.row_ptr[qs + 1].to(torch.int64) - starts
        mask[self.col_idx[_ragged_positions(starts, degs)].to(torch.int64)] = True
        count_host_copy(mask.device)
        return mask

    def neighbor_mask_many(self, masks: torch.Tensor) -> torch.Tensor:
        """Batched :meth:`neighbor_mask`: bool (B, n_rows) -> bool (B, n_cols),
        one ragged gather for the whole batch."""
        out = torch.zeros((masks.shape[0], self.n_cols), dtype=torch.bool,
                          device=masks.device)
        count(HOST_SYNCS)
        bs, qs = torch.nonzero(masks[:, : self.n_rows], as_tuple=True)
        starts = self.row_ptr[qs].to(torch.int64)
        degs = self.row_ptr[qs + 1].to(torch.int64) - starts
        flat = _ragged_positions(starts, degs)
        out[torch.repeat_interleave(bs, degs, output_size=flat.numel()),
            self.col_idx[flat].to(torch.int64)] = True
        count_host_copy(out.device)
        return out

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    def nbytes(self) -> int:
        return _nbytes(self.row_ptr) + _nbytes(self.col_idx)


# ---------------------------------------------------------------------------
# Bit-packing helpers (int32 words, little-endian within the word)
# ---------------------------------------------------------------------------
def pack_bitplane(dense: torch.Tensor) -> torch.Tensor:
    """Pack bool (R, C) -> int32 (R, ceil(C/32)); bit j of word w = col 32w+j."""
    return pack_bits(dense.to(torch.bool))


def unpack_bitplane(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    return unpack_bits(words, n_cols)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Pack one bool vector (n,) -> int32 (ceil(n/32),)."""
    return pack_bits(mask.to(torch.bool)[None, :])[0]


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_mask`."""
    return unpack_bits(words[None, :], n)[0]


def pack_pairs(rows: torch.Tensor, cols: torch.Tensor, n_rows: int, n_cols: int,
               min_words: int = 0) -> torch.Tensor:
    """Scatter (row, col) edges into a packed int32 bitplane
    (n_rows, max(ceil(n_cols/32), min_words)) without building the dense
    (n_rows, n_cols) matrix.  Out-of-range and negative edges are dropped;
    duplicate edges are merged first, so the per-word sum of distinct bits
    is their OR."""
    n_words = max((n_cols + 31) // 32, min_words)
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    key = torch.unique((rows[keep] << 32) | cols[keep])
    rows, cols = key >> 32, key & 0xFFFFFFFF
    flat = torch.zeros(n_rows * n_words, dtype=torch.int64, device=key.device)
    flat.index_add_(0, rows * n_words + (cols >> 5), torch.ones_like(cols) << (cols & 31))
    return wrap_int32(flat).view(n_rows, n_words)


def bitplane_or_reduce(sel_words: torch.Tensor, plane: torch.Tensor,
                       n_mid: int) -> torch.Tensor:
    """(OR, AND)-contract packed selectors (B, ceil(n_mid/32)) against a
    packed relation (n_mid, W) -> (B, W): row b = OR of the plane rows whose
    selector bit is set.  The same contraction as
    :func:`repro_torch.kernels.ops.bitmatmul`, and dispatched through it: a
    CUDA operand launches the kernel, a CPU operand takes its plain version."""
    sel = torch.atleast_2d(sel_words)[:, : (n_mid + 31) // 32]
    return K.bitmatmul(sel, plane[:n_mid])


def bitplane_popcount(words: torch.Tensor) -> int:
    """Number of set bits in a packed bitplane (the relation's nnz)."""
    count(HOST_SYNCS)
    return int(popcount32(words).sum())


# ---------------------------------------------------------------------------
# Structured (implicit) per-slot relation forms
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlotIdentity:
    """The relation is ``I_n`` — transformation / vertical ops.  O(1) bytes."""

    n: int

    def n_links(self) -> int:
        return self.n

    def nbytes(self) -> int:
        return 0

    def out_to_in(self, n_out: int, device) -> torch.Tensor:
        return torch.arange(n_out, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class SlotGather:
    """Each output derives from AT MOST one input: ``src[o]`` = input row of
    output ``o``, ``-1`` = no link — the op's own capture payload."""

    src: torch.Tensor  # int32 (n_out,)

    def n_links(self) -> int:
        count(HOST_SYNCS)
        return int(torch.count_nonzero(self.src >= 0))

    def nbytes(self) -> int:
        return _nbytes(self.src)

    def out_to_in(self, n_out: int, device) -> torch.Tensor:
        return self.src


@dataclasses.dataclass(frozen=True)
class SlotRange:
    """One identity block: outputs ``[start, start+length)`` map to inputs
    ``[0, length)`` — append's block-diagonal tensors as two offsets."""

    start: int
    length: int

    def n_links(self) -> int:
        return self.length

    def nbytes(self) -> int:
        return 0

    def out_to_in(self, n_out: int, device) -> torch.Tensor:
        g = torch.full((n_out,), -1, dtype=torch.int32, device=device)
        g[self.start: self.start + self.length] = torch.arange(
            self.length, dtype=torch.int32, device=device)
        return g


SlotStructure = Union[SlotIdentity, SlotGather, SlotRange]


def _identity_csr(n: int, device) -> CSR:
    i = torch.arange(n, dtype=torch.int32, device=device)
    return CSR(n_rows=n, n_cols=n,
               row_ptr=torch.arange(n + 1, dtype=torch.int32, device=device), col_idx=i)


def _gather_bwd_csr(g: torch.Tensor, n_in: int) -> CSR:
    """out->in CSR of a gather: every row has <= 1 entry — a cumsum, no sort."""
    valid = g >= 0
    row_ptr = torch.zeros(len(g) + 1, dtype=torch.int32, device=g.device)
    row_ptr[1:] = torch.cumsum(valid.to(torch.int32), dim=0)
    count(HOST_SYNCS)
    return CSR(n_rows=len(g), n_cols=n_in, row_ptr=row_ptr, col_idx=g[valid].to(torch.int32))


# ---------------------------------------------------------------------------
# The provenance tensor itself
# ---------------------------------------------------------------------------
class ProvTensor:
    """Order-(k+1) sparse binary tensor for one data-processing operation.

    Construct with EITHER an explicit ``coo`` index list or per-slot
    ``slots`` structures.  ``device`` is where every array of the tensor
    lives; it defaults to the device of the arrays given, and a tensor
    made of identity and range slots alone needs it (``None`` -> CUDA).
    """

    def __init__(
        self,
        n_out: int,
        n_in: tuple,
        coo: Optional[torch.Tensor] = None,
        *,
        slots: Optional[Sequence[SlotStructure]] = None,
        device=None,
    ) -> None:
        self.n_out = int(n_out)
        self.n_in = tuple(int(n) for n in n_in)
        if (coo is None) == (slots is None):
            raise ValueError("pass exactly one of coo= or slots=")
        self._slots: Optional[Tuple[SlotStructure, ...]] = None
        self._coo: Optional[torch.Tensor] = None
        if slots is not None:
            slots = tuple(slots)
            if len(slots) != len(self.n_in):
                raise ValueError(
                    f"{len(slots)} slot structures inconsistent with "
                    f"k={len(self.n_in)} inputs"
                )
            arrays = [s.src for s in slots if isinstance(s, SlotGather)]
            self.device = arrays[0].device if arrays else resolve_device(device)
            self._slots = slots
        else:
            coo = torch.as_tensor(coo, dtype=torch.int32)
            if coo.ndim != 2 or coo.shape[1] != 1 + len(self.n_in):
                raise ValueError(
                    f"coo shape {tuple(coo.shape)} inconsistent with k={len(self.n_in)} inputs"
                )
            self.device = coo.device
            self._coo = coo
        self._fwd: Optional[list] = None
        self._bwd: Optional[list] = None
        self._bpf: Optional[list] = None
        self._bpb: Optional[list] = None
        self._sg: Optional[list] = None  # memoized out->in gather per slot
        self._slot_nnz: Optional[list] = None

    def __repr__(self) -> str:
        tag = "structured" if self.structured else "coo"
        return (f"ProvTensor(n_out={self.n_out}, n_in={self.n_in}, "
                f"nnz={self.nnz}, repr={tag}, device={self.device})")

    @property
    def k(self) -> int:
        return len(self.n_in)

    @property
    def structured(self) -> bool:
        return self._slots is not None

    @property
    def nnz(self) -> int:
        """Rows of the (possibly virtual) COO index list."""
        if self._slots is not None:
            return self.n_out
        return int(self._coo.shape[0])

    # -- representation access ----------------------------------------------
    def slot_structure(self, inp: int) -> Optional[SlotStructure]:
        return self._slots[inp] if self._slots is not None else None

    def slot_gather(self, inp: int) -> Optional[torch.Tensor]:
        """int32 (n_out,) output->input map of a STRUCTURED slot (-1 = no
        link), memoized; None for explicit-COO tensors."""
        s = self.slot_structure(inp)
        if s is None:
            return None
        if isinstance(s, SlotGather):
            return s.src
        if self._sg is None:
            self._sg = [None] * self.k
        if self._sg[inp] is None:
            self._sg[inp] = s.out_to_in(self.n_out, self.device)
        return self._sg[inp]

    @property
    def coo(self) -> torch.Tensor:
        """(nnz, 1+k) int32 explicit index list (a lazy, retained mirror for
        structured tensors)."""
        if self._coo is None:
            cols = [torch.arange(self.n_out, dtype=torch.int32, device=self.device)]
            cols += [self.slot_gather(i) for i in range(self.k)]
            self._coo = torch.stack(cols, dim=1)
        return self._coo

    def as_coo(self) -> "ProvTensor":
        """A forced-COO twin of this tensor (parity baselines)."""
        return ProvTensor(n_out=self.n_out, n_in=self.n_in, coo=self.coo.clone())

    # -- per-slot relation statistics (the cost model reads these) -----------
    def slot_nnz(self, inp: int) -> int:
        """nnz of the input-``inp`` -> output relation: links that are real
        (not the -1 sentinel).  Memoized; structured slots answer off the
        implicit form, nothing is materialized."""
        if self._slot_nnz is None:
            self._slot_nnz = [None] * self.k
        if self._slot_nnz[inp] is None:
            s = self.slot_structure(inp)
            if s is not None:
                self._slot_nnz[inp] = s.n_links()
            else:
                count(HOST_SYNCS)
                self._slot_nnz[inp] = int(torch.count_nonzero(self._coo[:, 1 + inp] >= 0))
        return self._slot_nnz[inp]

    def slot_shape(self, inp: int) -> tuple:
        """(rows, cols) of the input-``inp`` forward relation."""
        return (self.n_in[inp], self.n_out)

    def slot_density(self, inp: int) -> float:
        """nnz / (rows * cols) of the input-``inp`` forward relation."""
        cells = self.n_in[inp] * self.n_out
        return self.slot_nnz(inp) / cells if cells else 0.0

    def slot_nnz_range(self, inp: int, lo: int, hi: int) -> int:
        """nnz of the input-``inp`` relation restricted to output rows
        ``[lo, hi)`` — the shard-local statistic the sharded hop-cache's
        cost model reads.  Identity and range slots answer by interval
        arithmetic, a gather by one count over its window."""
        lo = max(int(lo), 0)
        hi = min(int(hi), self.n_out)
        if hi <= lo:
            return 0
        s = self.slot_structure(inp)
        if isinstance(s, SlotIdentity):
            return max(0, min(hi, s.n) - lo)
        if isinstance(s, SlotRange):
            return max(0, min(hi, s.start + s.length) - max(lo, s.start))
        count(HOST_SYNCS)
        if isinstance(s, SlotGather):
            return int(torch.count_nonzero(s.src[lo:hi] >= 0))
        out = self._coo[:, 0]
        inn = self._coo[:, 1 + inp]
        return int(torch.count_nonzero((out >= lo) & (out < hi) & (inn >= 0)))

    def slice_rows(self, lo: int, hi: int) -> "ProvTensor":
        """The tensor restricted to output rows ``[lo, hi)``: ``n_out = hi -
        lo`` over the SAME (global) input spaces, on the same device.

        Structured slots stay structured: a gather slot slices its payload
        (a view, no copy); an identity or range slot becomes a window
        gather of ``hi - lo`` int32 (the only slot kind that allocates).
        Explicit COO keeps the rows landing in the window (a copy),
        out-column shifted to shard-local coordinates.  ``-1`` sentinels
        inside the window survive."""
        lo = max(int(lo), 0)
        hi = min(int(hi), self.n_out)
        if hi < lo:
            raise ValueError(f"bad row range [{lo}, {hi})")
        if self._slots is not None:
            sliced = []
            for s in self._slots:
                if isinstance(s, SlotGather):
                    g = s.src[lo:hi]
                elif isinstance(s, SlotIdentity):
                    g = torch.arange(lo, hi, dtype=torch.int32, device=self.device)
                else:
                    g = torch.full((hi - lo,), -1, dtype=torch.int32, device=self.device)
                    a, b = max(lo, s.start), min(hi, s.start + s.length)
                    if b > a:
                        g[a - lo: b - lo] = torch.arange(a - s.start, b - s.start,
                                                         dtype=torch.int32, device=self.device)
                sliced.append(SlotGather(g))
            return ProvTensor(n_out=hi - lo, n_in=self.n_in, slots=sliced, device=self.device)
        out = self._coo[:, 0]
        sub = self._coo[(out >= lo) & (out < hi)]
        sub[:, 0] -= lo
        return ProvTensor(n_out=hi - lo, n_in=self.n_in, coo=sub)

    def _slot_pairs(self, inp: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Valid (out, in) link pairs of one slot, from whichever regime."""
        g = self.slot_gather(inp)
        if g is not None:
            count(HOST_SYNCS)
            out = torch.nonzero(g >= 0).reshape(-1).to(torch.int32)
            return out, g[out.long()]
        return self._coo[:, 0], self._coo[:, 1 + inp]

    # -- the paper's optimized representation (bidirectional CSR) -----------
    def fwd(self, inp: int) -> CSR:
        """input-record -> output-records CSR for input ``inp``."""
        if self._fwd is None:
            self._fwd = [None] * self.k
        if self._fwd[inp] is None:
            s = self.slot_structure(inp)
            if isinstance(s, SlotIdentity):
                self._fwd[inp] = _identity_csr(s.n, self.device)
            else:
                out, inn = self._slot_pairs(inp)
                self._fwd[inp] = CSR.from_pairs(inn, out, self.n_in[inp], self.n_out)
        return self._fwd[inp]

    def bwd(self, inp: int) -> CSR:
        """output-record -> input-records CSR for input ``inp``."""
        if self._bwd is None:
            self._bwd = [None] * self.k
        if self._bwd[inp] is None:
            s = self.slot_structure(inp)
            if isinstance(s, SlotIdentity):
                self._bwd[inp] = _identity_csr(s.n, self.device)
            elif s is not None:
                self._bwd[inp] = _gather_bwd_csr(self.slot_gather(inp), self.n_in[inp])
            else:
                self._bwd[inp] = CSR.from_pairs(
                    self._coo[:, 0], self._coo[:, 1 + inp], self.n_out, self.n_in[inp]
                )
        return self._bwd[inp]

    # -- paper §IV: slice + project, expressed on masks ---------------------
    def forward_mask(self, inp: int, in_mask: torch.Tensor) -> torch.Tensor:
        """project(slice(T, p_in, rows), p_out) with rows given as a mask."""
        return self.forward_mask_batch(inp, in_mask[None, :])[0]

    def backward_mask(self, inp: int, out_mask: torch.Tensor) -> torch.Tensor:
        """project(slice(T, p_out, rows), p_in)."""
        return self.backward_mask_batch(inp, out_mask[None, :])[0]

    def forward_mask_batch(self, inp: int, in_masks: torch.Tensor) -> torch.Tensor:
        """Batched :meth:`forward_mask`: bool (B, n_in[inp]) -> (B, n_out)."""
        s = self.slot_structure(inp)
        if s is not None:
            return self._forward_structured(s, in_masks, inp)
        return self.fwd(inp).neighbor_mask_many(in_masks)

    def backward_mask_batch(self, inp: int, out_masks: torch.Tensor) -> torch.Tensor:
        """Batched :meth:`backward_mask`: bool (B, n_out) -> (B, n_in[inp])."""
        s = self.slot_structure(inp)
        if s is not None:
            return self._backward_structured(s, out_masks, inp)
        return self.bwd(inp).neighbor_mask_many(out_masks)

    def _forward_structured(self, s: SlotStructure, masks: torch.Tensor,
                            inp: int) -> torch.Tensor:
        n_in = self.n_in[inp]
        if isinstance(s, SlotIdentity):
            return masks[:, : s.n].clone()
        if isinstance(s, SlotRange):
            out = torch.zeros((masks.shape[0], self.n_out), dtype=torch.bool,
                              device=masks.device)
            out[:, s.start: s.start + s.length] = masks[:, : s.length]
            return out
        g = s.src
        valid = g >= 0
        safe = torch.where(valid, g, torch.zeros_like(g)).long()
        return masks[:, :n_in][:, safe] & valid[None, :]

    def _backward_structured(self, s: SlotStructure, masks: torch.Tensor,
                             inp: int) -> torch.Tensor:
        n_in = self.n_in[inp]
        if isinstance(s, SlotIdentity):
            return masks[:, : s.n].clone()
        out = torch.zeros((masks.shape[0], n_in), dtype=torch.bool, device=masks.device)
        if isinstance(s, SlotRange):
            out[:, : s.length] = masks[:, s.start: s.start + s.length]
            return out
        g = s.src
        sel = masks[:, : self.n_out] & (g >= 0)[None, :]
        count(HOST_SYNCS)
        bs, os_ = torch.nonzero(sel, as_tuple=True)
        out[bs, g[os_].long()] = True
        count_host_copy(out.device)
        return out

    def forward_rows(self, inp: int, rows) -> torch.Tensor:
        """Sorted-unique output rows (int64) linked to the given input rows."""
        rows = _as_row_indices(rows, self.n_in[inp], self.device)
        s = self.slot_structure(inp)
        if isinstance(s, SlotIdentity):
            return torch.unique(rows)
        if isinstance(s, SlotRange):
            return torch.unique(rows[rows < s.length]) + s.start
        if isinstance(s, SlotGather):
            return torch.nonzero(torch.isin(s.src.long(), rows)).reshape(-1)
        return self.fwd(inp).gather_rows(rows)

    def backward_rows(self, inp: int, rows) -> torch.Tensor:
        """Sorted-unique input rows (int64) the given output rows derive from."""
        rows = _as_row_indices(rows, self.n_out, self.device)
        s = self.slot_structure(inp)
        if isinstance(s, SlotIdentity):
            return torch.unique(rows)
        if isinstance(s, SlotRange):
            rows = rows[(rows >= s.start) & (rows < s.start + s.length)]
            return torch.unique(rows) - s.start
        if isinstance(s, SlotGather):
            vals = s.src[rows]
            return torch.unique(vals[vals >= 0]).to(torch.int64)
        return self.bwd(inp).gather_rows(rows)

    # -- bitplane views (the fused walk streams these) ----------------------
    def bitplane_fwd(self, inp: int) -> torch.Tensor:
        """int32 (n_in[inp], ceil(n_out/32)) relation matrix R[i, o].
        Memoized on the tensor's device; packed straight from the link
        pairs, never through the dense (n_in, n_out) matrix."""
        if self._bpf is None:
            self._bpf = [None] * self.k
        if self._bpf[inp] is None:
            out, inn = self._slot_pairs(inp)
            count(HOST_SYNCS, 3)    # pack_pairs: two boolean indexes, a unique
            self._bpf[inp] = pack_pairs(inn, out, self.n_in[inp], self.n_out)
        return self._bpf[inp]

    def bitplane_bwd(self, inp: int) -> torch.Tensor:
        """int32 (n_out, ceil(n_in[inp]/32)) relation matrix R[o, i]."""
        if self._bpb is None:
            self._bpb = [None] * self.k
        if self._bpb[inp] is None:
            out, inn = self._slot_pairs(inp)
            count(HOST_SYNCS, 3)    # pack_pairs: two boolean indexes, a unique
            self._bpb[inp] = pack_pairs(out, inn, self.n_out, self.n_in[inp])
        return self._bpb[inp]

    # -- set-semantics canonicalization (paper §III-C.a) ---------------------
    def canonicalize(self, duplicate_groups) -> "ProvTensor":
        """Bag -> set semantics: map each output index to the smallest index
        of its duplicate group."""
        groups = torch.as_tensor(duplicate_groups, dtype=torch.int32, device=self.device)
        if tuple(groups.shape) != (self.n_out,):
            raise ValueError("duplicate_groups must have one entry per output record")
        coo = self.coo.clone()
        coo[:, 0] = groups[coo[:, 0].long()]
        return ProvTensor(n_out=self.n_out, n_in=self.n_in,
                          coo=torch.unique(coo, dim=0))

    # -- payload round-trip (the spill tier's serialisation) -------------------
    def resident(self) -> "ProvTensor":
        """This tensor, guaranteed resident.  A real tensor answers itself;
        a spill-tier :class:`~repro_torch.core.spill._TensorFault`
        intercepts this to rehydrate — callers about to read capture payload
        aliases off ``op.info`` (recompute) touch it first."""
        return self

    def to_payload(self) -> Tuple[dict, dict]:
        """(meta, arrays) of the CANONICAL regime only; the lazily-built
        mirrors rebuild byte-identically after :meth:`from_payload`.  Same
        meta layout as ``repro``'s ``ProvTensor.to_payload``."""
        meta: dict = {"n_out": self.n_out, "n_in": list(self.n_in)}
        arrays: dict = {}
        if self._slots is not None:
            descs = []
            for i, s in enumerate(self._slots):
                if isinstance(s, SlotIdentity):
                    descs.append({"kind": "identity", "n": s.n})
                elif isinstance(s, SlotRange):
                    descs.append({"kind": "range", "start": s.start, "length": s.length})
                else:
                    descs.append({"kind": "gather"})
                    arrays[f"slot{i}"] = s.src
            meta["slots"] = descs
        else:
            arrays["coo"] = self._coo
        return meta, arrays

    @staticmethod
    def from_payload(meta: dict, arrays: dict, device=None) -> "ProvTensor":
        """Inverse of :meth:`to_payload`; ``arrays`` may be numpy arrays (a
        payload from ``repro``, or the spill store's read-only memmap
        views: each is copied once into a writable host array) or tensors,
        and land on ``device`` in one copy each."""
        device = resolve_device(device)

        def _arr(x) -> torch.Tensor:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, dtype=np.int32))
            return x.to(device=device, dtype=torch.int32)

        n_out = int(meta["n_out"])
        n_in = tuple(int(n) for n in meta["n_in"])
        if "slots" in meta:
            slots: List[SlotStructure] = []
            for i, d in enumerate(meta["slots"]):
                if d["kind"] == "identity":
                    slots.append(SlotIdentity(int(d["n"])))
                elif d["kind"] == "range":
                    slots.append(SlotRange(int(d["start"]), int(d["length"])))
                else:
                    slots.append(SlotGather(_arr(arrays[f"slot{i}"])))
            return ProvTensor(n_out=n_out, n_in=n_in, slots=slots, device=device)
        return ProvTensor(n_out=n_out, n_in=n_in, coo=_arr(arrays["coo"]))

    # -- memory accounting (Table IX / XI) -----------------------------------
    def nbytes(self, include_index: bool = True) -> int:
        """Bytes of the provenance encoding, counted as ``repro`` counts them;
        ``include_index`` adds every lazily-built mirror."""
        if self._slots is not None:
            total = sum(s.nbytes() for s in self._slots)
            if include_index:
                if self._coo is not None:
                    total += _nbytes(self._coo)
                for g in self._sg or []:
                    if g is not None:
                        total += _nbytes(g)
        else:
            total = _nbytes(self._coo)
        if include_index:
            for half in (self._fwd or []), (self._bwd or []):
                for csr in half:
                    if csr is not None:
                        total += csr.nbytes()
            for half in (self._bpf or []), (self._bpb or []):
                for plane in half:
                    if plane is not None:
                        total += _nbytes(plane)
        return total


def _as_row_indices(rows, n: int, device) -> torch.Tensor:
    """Probe rows -> flat int64 index tensor on ``device``.  Bounds-checked
    (IndexError on out-of-range); negative indices wrap like numpy's."""
    if isinstance(rows, torch.Tensor) and rows.dtype == torch.bool:
        return torch.nonzero(rows.to(device)).reshape(-1)
    if isinstance(rows, np.ndarray) and rows.dtype == bool:
        return torch.nonzero(torch.from_numpy(rows).to(device)).reshape(-1)
    if isinstance(rows, (torch.Tensor, np.ndarray)):
        idx = torch.as_tensor(rows).to(device=device, dtype=torch.int64).reshape(-1)
    else:
        idx = torch.as_tensor(list(rows), dtype=torch.int64, device=device)
    if idx.numel() and (int(idx.min()) < -n or int(idx.max()) >= n):
        raise IndexError(f"probe row out of range for axis of size {n}")
    return torch.where(idx < 0, idx + n, idx)


# ---------------------------------------------------------------------------
# Row-range partitioning (the sharded index's layout contract)
# ---------------------------------------------------------------------------
def shard_ranges(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous balanced row ranges ``[(lo, hi), ...]`` partitioning
    ``[0, n)`` into ``n_shards`` pieces (``np.array_split`` semantics: the
    first ``n % n_shards`` shards take one extra row).  Shard counts above
    ``n`` yield empty trailing ranges."""
    n = int(n)
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(n, n_shards)
    ranges: List[Tuple[int, int]] = []
    lo = 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


# ---------------------------------------------------------------------------
# Constructors per operation category (paper §III-A a..g)
# ---------------------------------------------------------------------------
def identity_tensor(n: int, structured: bool = True, device=None) -> ProvTensor:
    """Transformation / vertical ops: the 2-D identity, stored as a scalar."""
    if not structured:
        idx = torch.arange(n, dtype=torch.int32, device=resolve_device(device))
        return ProvTensor(n_out=n, n_in=(n,), coo=torch.stack([idx, idx], dim=1))
    return ProvTensor(n_out=n, n_in=(n,), slots=(SlotIdentity(n),), device=device)


def hreduce_tensor(kept: torch.Tensor, n_in: int, structured: bool = True) -> ProvTensor:
    """Horizontal reduction: ``kept[i]`` = input index of output record i."""
    kept = kept.to(torch.int32)
    if not structured:
        out = torch.arange(len(kept), dtype=torch.int32, device=kept.device)
        return ProvTensor(n_out=len(kept), n_in=(n_in,), coo=torch.stack([out, kept], dim=1))
    return ProvTensor(n_out=len(kept), n_in=(n_in,), slots=(SlotGather(kept),))


def haugment_tensor(src: torch.Tensor, n_in: int, structured: bool = True) -> ProvTensor:
    """Horizontal augmentation: ``src[o]`` = input index of output o, or -1."""
    src = src.to(torch.int32)
    if not structured:
        out = torch.arange(len(src), dtype=torch.int32, device=src.device)
        return ProvTensor(n_out=len(src), n_in=(n_in,), coo=torch.stack([out, src], dim=1))
    return ProvTensor(n_out=len(src), n_in=(n_in,), slots=(SlotGather(src),))


def join_tensor(pairs: torch.Tensor, n_left: int, n_right: int,
                n_out: Optional[int] = None, structured: bool = True) -> ProvTensor:
    """Join: order-3 tensor over (n_out, 2) pairs, -1 for outer dangles."""
    pairs = pairs.to(torch.int32)
    if n_out is None:
        n_out = len(pairs)
    if not structured or n_out != len(pairs):
        out = torch.arange(len(pairs), dtype=torch.int32, device=pairs.device)
        coo = torch.cat([out[:, None], pairs], dim=1)
        return ProvTensor(n_out=n_out, n_in=(n_left, n_right), coo=coo)
    return ProvTensor(
        n_out=n_out,
        n_in=(n_left, n_right),
        slots=(SlotGather(pairs[:, 0].contiguous()), SlotGather(pairs[:, 1].contiguous())),
    )


def append_tensor(n_left: int, n_right: int, structured: bool = True,
                  device=None) -> ProvTensor:
    """Append: two block-diagonal 2-D tensors, stored as two block offsets."""
    if not structured:
        out = torch.arange(n_left + n_right, dtype=torch.int32, device=resolve_device(device))
        neg = torch.full_like(out, -1)
        left = torch.where(out < n_left, out, neg)
        right = torch.where(out >= n_left, out - n_left, neg)
        return ProvTensor(n_out=n_left + n_right, n_in=(n_left, n_right),
                          coo=torch.stack([out, left, right], dim=1))
    return ProvTensor(
        n_out=n_left + n_right,
        n_in=(n_left, n_right),
        slots=(SlotRange(0, n_left), SlotRange(n_left, n_right)),
        device=device,
    )
