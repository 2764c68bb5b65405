"""The reference pipeline and the lineage answers it gives.

Every op of these pipelines relates each output row (column) to at most
one row (column) of each input, so a dataset's lineage in a source is one
row map and one column map, composed op by op: ``row_map[r]`` is the
source row output row ``r`` derives from (-1: none).  Record answers read
the row map; cell answers are the product of the rows and the columns
reached, since rows and columns map independently.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import numpy as np

from provbench.hosttable import HostTable
from provbench.reference import rounder


@dataclasses.dataclass
class Lineage:
    sink: HostTable
    # per op: (n_out_rows, n_out_cols, [(input name, row gather, col gather)])
    ops: List[Tuple[int, int, list]]
    # source name -> (row map, column map) of the sink
    maps: Dict[str, Tuple[np.ndarray, np.ndarray]]


def _compose(maps, rows, cols):
    """A dataset's maps after an op whose gathers are ``rows``/``cols``."""
    out = {}
    for src, (rmap, cmap) in maps.items():
        out[src] = (np.where(rows >= 0, rmap[np.maximum(rows, 0)], -1),
                    np.where(cols >= 0, cmap[np.maximum(cols, 0)], -1))
    return out


def run_pipeline(config: dict, tables: Dict[str, HostTable],
                 precision: str = "float32") -> Lineage:
    """Apply ``config["pipeline"]`` to the host tables in ``precision``."""
    rnd = rounder(precision)
    tables = {n: HostTable(t.columns, rnd(t.data), t.null) for n, t in tables.items()}
    ident = {n: {n: (np.arange(t.n_rows), np.arange(t.n_cols))} for n, t in tables.items()}
    cur, cur_maps = tables[config["start"]], ident[config["start"]]
    ops = []
    for step in config["pipeline"]:
        mod = importlib.import_module(f"provbench.reference.ops.{step['op']}")
        out, inputs = mod.apply(cur, tables, rnd, **step.get("args", {}))
        maps = {}
        for name, rows, cols in inputs:
            maps.update(_compose(cur_maps if name == "cur" else ident[name], rows, cols))
        ops.append((out.n_rows, out.n_cols, inputs))
        cur, cur_maps = out, maps
    return Lineage(sink=cur, ops=ops, maps=cur_maps)


class Answers:
    """Q1-Q4 over one reference pipeline.  Probes are (B, k) row arrays and
    (B, a) attribute arrays; answers are sorted int64 row arrays (Q1, Q2)
    or row-major ``(n, 2)`` cell arrays (Q3, Q4), one per probe."""

    def __init__(self, lin: Lineage):
        self.lin = lin
        self._inverse = {}

    def _sink_rows_of(self, src: str):
        if src not in self._inverse:
            rmap = self.lin.maps[src][0]
            order = np.argsort(rmap, kind="stable")
            self._inverse[src] = (order, rmap[order])
        return self._inverse[src]

    def forward_rows(self, src: str, probe) -> np.ndarray:
        order, keys = self._sink_rows_of(src)
        p = np.unique(probe)
        lo, hi = np.searchsorted(keys, p, "left"), np.searchsorted(keys, p, "right")
        if not len(p):
            return np.zeros(0, np.int64)
        return np.sort(np.concatenate([order[a:b] for a, b in zip(lo, hi)])).astype(np.int64)

    def backward_rows(self, src: str, probe) -> np.ndarray:
        rmap = self.lin.maps[src][0]
        probe = np.asarray(probe)
        probe = probe[(probe >= 0) & (probe < len(rmap))]
        r = rmap[probe]
        return np.unique(r[r >= 0]).astype(np.int64)

    def forward_cols(self, src: str, attrs) -> np.ndarray:
        return np.nonzero(np.isin(self.lin.maps[src][1], attrs))[0]

    def backward_cols(self, src: str, attrs) -> np.ndarray:
        cmap = self.lin.maps[src][1]
        attrs = np.asarray(attrs)
        c = cmap[attrs[(attrs >= 0) & (attrs < len(cmap))]]
        return np.unique(c[c >= 0])

    @staticmethod
    def _cells(rows, cols) -> np.ndarray:
        if not len(rows) or not len(cols):
            return np.zeros((0, 2), np.int64)
        return np.stack(np.meshgrid(rows, cols, indexing="ij"), -1).reshape(-1, 2).astype(np.int64)

    def answer(self, q: str, src: str, rows, attrs=None) -> List[np.ndarray]:
        out = []
        for b in range(len(rows)):
            if q == "q1":
                out.append(self.forward_rows(src, rows[b]))
            elif q == "q2":
                out.append(self.backward_rows(src, rows[b]))
            elif q == "q3":
                out.append(self._cells(self.forward_rows(src, rows[b]),
                                       self.forward_cols(src, attrs[b])))
            elif q == "q4":
                out.append(self._cells(self.backward_rows(src, rows[b]),
                                       self.backward_cols(src, attrs[b])))
            else:
                raise ValueError(f"unknown query kind {q!r}")
        return out


def count_wrong(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    """Probes whose answer differs (a missing answer counts as wrong)."""
    wrong = abs(len(got) - len(want))
    for g, w in zip(got, want):
        wrong += int(g is None or g.shape != w.shape or not np.array_equal(g, w))
    return wrong


def relation_mismatches(got, want) -> int:
    """Entries in which two pipelines' per-op relations differ: every output
    row and column whose input row or column differs, per op and input,
    plus the difference in their numbers; a missing op counts all its
    entries."""
    def size(op):
        return sum(len(r) + len(c) for _, r, c in op[2])

    bad = sum(size(op) for op in got[len(want):]) + sum(size(op) for op in want[len(got):])
    for g, w in zip(got, want):
        bad += abs(len(g[2]) - len(w[2]))
        for (_, gr, gc), (_, wr, wc) in zip(g[2], w[2]):
            for a, b in ((gr, wr), (gc, wc)):
                n = min(len(a), len(b))
                bad += abs(len(a) - len(b)) + int(np.count_nonzero(a[:n] != b[:n]))
    return bad


SHAPE_MISMATCH = 1e9


def value_gap(got: HostTable, want: HostTable) -> float:
    """The widest gap between two sinks' values over their non-null cells;
    ``SHAPE_MISMATCH`` where their columns, shapes or null flags differ."""
    if got.columns != want.columns or got.data.shape != want.data.shape \
            or not np.array_equal(got.null, want.null):
        return SHAPE_MISMATCH
    live = ~want.null
    if not live.any():
        return 0.0
    return float(np.max(np.abs(got.data[live].astype(np.float64)
                               - want.data[live].astype(np.float64))))
