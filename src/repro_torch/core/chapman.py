"""Chapman-et-al.-style BASELINE: eager cell-level why-provenance, on a device.

The comparison system of the paper's §V (Chapman et al., TODS 2024) in the
port's own substrate, so Table IX (memory) and Table XI (join scale)
isolate the representation difference rather than the host language:

* the tracked frame is captured BOTH before and after each manipulation
  (both copies retained on the index's device — the cost the paper calls
  out);
* provenance is derived by comparing the two versions and materialized
  EAGERLY per CELL: one explicit ``(out_row, out_col, in_slot, in_row,
  in_col)`` int64 record per derived attribute value;
* the join reconstructs row matches observationally by hashing record
  values, not by instrumented row ids;
* queries are O(T) scans over every record of every op on the path.

The row matching runs on the device by sort and ``searchsorted``; the
``records`` arrays equal ``repro.core.chapman``'s byte for byte, order
included: per output row the left matches by ascending input row, then the
right ones, then the captured-pair fill-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.opcat import CaptureInfo, OpCategory
from repro_torch.dataprep.table import Table

__all__ = ["CellProv", "ChapmanIndex"]

_FNV_PRIME = 1099511628211
_NAN_BITS = 0x7FC00000            # np.float32(np.nan), the bits a null hashes as


@dataclasses.dataclass
class CellProv:
    """Eager cell-level provenance of ONE operation: int64 quintuple rows
    (out_row, out_col, in_slot, in_row, in_col) on the index's device."""

    op_name: str
    records: torch.Tensor  # (n, 5) int64

    def nbytes(self) -> int:
        return int(self.records.numel() * self.records.element_size())


def _last_positions(index: torch.Tensor, queries: torch.Tensor):
    """For each query value, the LAST position ``k`` with ``index[k] ==
    value`` (a dict built by enumeration keeps the last), and whether one
    exists."""
    vals, perm = torch.sort(index, stable=True)
    r = torch.searchsorted(vals, queries, right=True) - 1
    safe = r.clamp(min=0)
    found = (r >= 0) & (vals[safe] == queries) if vals.numel() else \
        torch.zeros_like(queries, dtype=torch.bool)
    pos = perm[safe] if vals.numel() else torch.zeros_like(queries)
    return pos, found


def _matches(keys: torch.Tensor, probes: torch.Tensor):
    """(rows sorted by key, stably; first match; match count) of each probe
    among ``keys``: the matching rows of probe i are
    ``perm[lo[i]: lo[i] + cnt[i]]``, in ascending row order."""
    vals, perm = torch.sort(keys, stable=True)
    lo = torch.searchsorted(vals, probes)
    hi = torch.searchsorted(vals, probes, right=True)
    return perm, lo, hi - lo


class ChapmanIndex:
    """Cell-level eager provenance store with before/after frame retention.

    Tables and records live on the device of the first tables it captures;
    a later table on another device raises."""

    def __init__(self) -> None:
        self.device: Optional[torch.device] = None
        self.cells: List[CellProv] = []
        self.frames: Dict[str, Table] = {}     # EVERY version retained
        self.op_io: List[Tuple[List[str], str]] = []

    # -- capture (observation-based: diff the frames) --------------------------
    def capture(
        self,
        input_ids: Sequence[str],
        inputs: Sequence[Table],
        output_id: str,
        output: Table,
        info: CaptureInfo,
    ) -> None:
        dev = output.device
        if self.device is None:
            self.device = dev
        for t in (*inputs, output):
            if t.device != self.device:
                raise ValueError(f"{info.op_name}: table on {t.device}, store on {self.device}")
        # Retain both versions (the design cost the paper measures).
        for d, t in zip(input_ids, inputs):
            self.frames.setdefault(d, t.copy())
        self.frames[output_id] = output.copy()
        self.op_io.append((list(input_ids), output_id))

        slot, orow, irow = self._derive_rows(inputs, output, info)
        # cell-level expansion through the schema correspondence: the pairs
        # of each slot, repeated once per row link (the eager per-cell cost)
        pairs = [torch.tensor(self._attr_pairs(inputs[k], output, info, k),
                              dtype=torch.int64, device=dev).reshape(-1, 2)
                 for k in range(len(inputs))]
        n_pairs = torch.tensor([len(p) for p in pairs], dtype=torch.int64, device=dev)
        pair_base = torch.cumsum(n_pairs, 0) - n_pairs
        per_link = n_pairs[slot]
        total = int(per_link.sum())
        link = torch.repeat_interleave(torch.arange(len(slot), device=dev), per_link,
                                       output_size=total)
        within = torch.arange(total, device=dev) - (torch.cumsum(per_link, 0) - per_link)[link]
        pair = torch.cat(pairs)[pair_base[slot[link]] + within] if total else \
            torch.zeros((0, 2), dtype=torch.int64, device=dev)
        records = torch.stack([orow[link], pair[:, 0], slot[link], irow[link], pair[:, 1]],
                              dim=1)
        self.cells.append(CellProv(op_name=info.op_name, records=records))

    # -- row matching by content hashing (observation-based) -------------------
    @staticmethod
    def _hash_rows(t: Table, cols: Optional[Sequence[int]] = None) -> torch.Tensor:
        """FNV-style product over each row's float32 words (nulls as NaN
        bits): ``repro``'s uint64 hash, as the int64 with the same bits
        (an int64 multiply-add wraps modulo 2^64 as the uint64 one does)."""
        data = t.data if cols is None else t.data[:, list(cols)]
        null = t.null if cols is None else t.null[:, list(cols)]
        bits = data.contiguous().view(torch.int32)
        bits = torch.where(null, torch.full_like(bits, _NAN_BITS), bits)
        words = bits.to(torch.int64) & 0xFFFFFFFF
        h = torch.zeros(len(words), dtype=torch.int64, device=words.device)
        for j in range(words.shape[1]):
            h = h * _FNV_PRIME + words[:, j]
        return h

    def _derive_rows(self, inputs: Sequence[Table], output: Table, info: CaptureInfo):
        """(slot, out_row, in_row) int64 links derived by frame comparison,
        in ``repro``'s order."""
        cat = info.category
        dev = output.device
        n = output.n_rows
        rows = torch.arange(n, dtype=torch.int64, device=dev)
        zeros = torch.zeros(n, dtype=torch.int64, device=dev)
        if cat in (OpCategory.TRANSFORM, OpCategory.VREDUCE, OpCategory.VAUGMENT):
            return zeros, rows, rows
        if cat is OpCategory.HREDUCE:
            # observational: match preserved indices (the last input row
            # holding each index value)
            pos, found = _last_positions(inputs[0].index, output.index)
            if not bool(found.all()):
                missing = int(output.index[~found][0])
                raise KeyError(missing)
            return zeros, rows, pos
        if cat is OpCategory.HAUGMENT:
            pos, found = _last_positions(inputs[0].index, output.index)
            if info.src_rows is not None:
                src = info.src_rows.to(torch.int64)
                pos = torch.where(found, pos, src)
                found = found | (src >= 0)
            return zeros[found], rows[found], pos[found]
        if cat is OpCategory.JOIN:
            return self._join_rows(inputs, output, info)
        if cat is OpCategory.APPEND:
            n_l = info.n_in[0]
            right = rows >= n_l
            return right.to(torch.int64), rows, torch.where(right, rows - n_l, rows)
        raise ValueError(cat)

    def _join_rows(self, inputs: Sequence[Table], output: Table, info: CaptureInfo):
        """Hash-match each output row's left/right projections (the join
        key is column 0 of the output by construction), then fall back to
        the captured pairs for rows whose hash had no match."""
        left, right = inputs
        dev = output.device
        lcols_out = list(range(0, left.n_cols))
        rcols_out = [0] + list(range(left.n_cols, output.n_cols))
        lperm, l_lo, l_cnt = _matches(self._hash_rows(left), self._hash_rows(output, lcols_out))
        rperm, r_lo, r_cnt = _matches(self._hash_rows(right), self._hash_rows(output, rcols_out))
        per_row = l_cnt + r_cnt
        total = int(per_row.sum())
        orow = torch.repeat_interleave(torch.arange(output.n_rows, device=dev), per_row,
                                       output_size=total)
        within = torch.arange(total, device=dev) - (torch.cumsum(per_row, 0) - per_row)[orow]
        is_left = within < l_cnt[orow]
        irow = torch.empty(total, dtype=torch.int64, device=dev)
        irow[is_left] = lperm[(l_lo[orow] + within)[is_left]]
        irow[~is_left] = rperm[(r_lo[orow] + within - l_cnt[orow])[~is_left]]
        slot = (~is_left).to(torch.int64)
        if info.join_pairs is None:
            return slot, orow, irow
        jp = info.join_pairs.to(torch.int64)
        fill = torch.stack([(jp[:, 0] >= 0) & (l_cnt == 0), (jp[:, 1] >= 0) & (r_cnt == 0)],
                           dim=1).reshape(-1)
        f_slot = torch.tensor([0, 1], dtype=torch.int64, device=dev).repeat(len(jp))
        f_orow = torch.arange(len(jp), dtype=torch.int64, device=dev).repeat_interleave(2)
        return (torch.cat([slot, f_slot[fill]]), torch.cat([orow, f_orow[fill]]),
                torch.cat([irow, jp.reshape(-1)[fill]]))

    @staticmethod
    def _attr_pairs(inp: Table, out: Table, info: CaptureInfo, slot: int) -> List[Tuple[int, int]]:
        """(out_col, in_col) correspondences for one input slot (schema
        level: a few hundred at most, on the host)."""
        amap = info.attr_maps[slot]
        if amap.kind == "identity":
            n = min(inp.n_cols, out.n_cols)
            return [(j, j) for j in range(n)]
        if amap.perm is not None:
            return [(j, int(a)) for j, a in enumerate(amap.perm.tolist()) if a >= 0]
        if amap.kind == "vreduce":
            kept = amap.bitset.indices().tolist()
            return [(j, int(a)) for j, a in enumerate(kept)]
        if amap.kind == "vaugment":
            m = amap.m
            pairs = [(j, j) for j in range(m)]
            srcs = [int(a) for a in amap.bitset.indices().tolist() if a < m]
            for j in range(m, out.n_cols):
                pairs.extend((j, a) for a in srcs)
            return pairs
        if amap.kind == "join":
            bits = amap.bitset
            return [(j, bits.rank(j) - 1) for j in range(out.n_cols) if bits.test(j)]
        raise ValueError(amap.kind)

    # -- accounting (what Table IX/XI measure for the baseline) ----------------
    def prov_nbytes(self) -> int:
        return sum(c.nbytes() for c in self.cells)

    def frames_nbytes(self) -> int:
        return sum(t.nbytes() for t in self.frames.values())

    def total_nbytes(self) -> int:
        return self.prov_nbytes() + self.frames_nbytes()

    # -- queries over the eager cell store (O(T) scans — the paper's point) ----
    def _scan(self, op_seq: Sequence[int], rows, match_col: int, take_col: int) -> torch.Tensor:
        dev = self.device if self.device is not None else torch.device("cpu")
        cur = torch.as_tensor(list(rows) if not isinstance(rows, torch.Tensor) else rows,
                              dtype=torch.int64, device=dev).reshape(-1)
        cur = torch.unique(cur)
        for oi in op_seq:
            recs = self.cells[oi].records   # every record: the O(T) scan
            cur = torch.unique(recs[torch.isin(recs[:, match_col], cur), take_col])
        return cur

    def backward_rows(self, op_seq: Sequence[int], out_rows) -> torch.Tensor:
        """Backward record lineage through a chain of op ids (scan-based):
        sorted int64 input rows, slots merged."""
        return self._scan(list(reversed(list(op_seq))), out_rows, 0, 3)

    def forward_rows(self, op_seq: Sequence[int], in_rows) -> torch.Tensor:
        """Forward record lineage through a chain of op ids (scan-based)."""
        return self._scan(list(op_seq), in_rows, 3, 0)
