"""TrackedTable — the decorator-pattern capture front-end (paper §V).

Every data-prep op of :mod:`repro_torch.dataprep.ops` is exposed as a
method that (1) executes the op on the table's device, (2) hands its
CaptureInfo to the shared :class:`ProvenanceIndex`, and (3) returns a new
TrackedTable for the output dataset.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

from repro_torch.core.opcat import CaptureInfo
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import ops as P
from repro_torch.dataprep.table import Table

__all__ = ["TrackedTable", "track"]

_counter = itertools.count()


def _fresh_id(stem: str) -> str:
    return f"{stem}#{next(_counter)}"


class TrackedTable:
    """Decorator around Table: proxies reads, intercepts data-prep ops."""

    def __init__(self, table: Table, index: ProvenanceIndex, dataset_id: str):
        self.table = table
        self.index = index
        self.dataset_id = dataset_id

    # ---- transparent proxying of reads --------------------------------------
    def __getattr__(self, name):
        return getattr(self.table, name)

    def __len__(self) -> int:
        return self.table.n_rows

    # ---- capture plumbing ----------------------------------------------------
    def _emit(
        self,
        out: Table,
        info: CaptureInfo,
        inputs: Sequence["TrackedTable"],
        keep_output: bool = False,
        out_id: Optional[str] = None,
    ) -> "TrackedTable":
        out_id = out_id or _fresh_id(info.op_name.split(":")[0])
        self.index.record(
            [t.dataset_id for t in inputs],
            out_id,
            out,
            info,
            keep_output=keep_output,
            input_tables=[t.table for t in inputs],
        )
        return TrackedTable(out, self.index, out_id)

    # ---- the intercepted operations (paper Table I) ---------------------------
    def value_transform(self, col, fn, **kw):
        out, info = P.value_transform(self.table, col, fn, **kw)
        return self._emit(out, info, [self])

    def binarize(self, col, threshold):
        out, info = P.binarize(self.table, col, threshold)
        return self._emit(out, info, [self])

    def normalize(self, cols, kind="zscore"):
        out, info = P.normalize(self.table, cols, kind)
        return self._emit(out, info, [self])

    def impute(self, cols, strategy="mean"):
        out, info = P.impute(self.table, cols, strategy)
        return self._emit(out, info, [self])

    def discretize(self, col, n_bins, kind="uniform"):
        out, info = P.discretize(self.table, col, n_bins, kind)
        return self._emit(out, info, [self])

    def select_columns(self, cols):
        out, info = P.select_columns(self.table, cols)
        return self._emit(out, info, [self])

    def drop_columns(self, cols):
        out, info = P.drop_columns(self.table, cols)
        return self._emit(out, info, [self])

    def filter_rows(self, mask, op_name="filter"):
        out, info = P.filter_rows(self.table, mask, op_name)
        return self._emit(out, info, [self])

    def undersample(self, frac, seed=0):
        out, info = P.undersample(self.table, frac, seed)
        return self._emit(out, info, [self])

    def onehot(self, col, n_values=None):
        out, info = P.onehot(self.table, col, n_values)
        return self._emit(out, info, [self])

    def string_indexer(self, col):
        out, info = P.string_indexer(self.table, col)
        return self._emit(out, info, [self])

    def space_transform(self, cols, proj, prefix="pc"):
        out, info = P.space_transform(self.table, cols, proj, prefix)
        return self._emit(out, info, [self])

    def oversample(self, frac, seed=0, noise=0.0):
        out, info = P.oversample(self.table, frac, seed, noise)
        return self._emit(out, info, [self])

    def join(self, other: "TrackedTable", on, how="inner"):
        out, info = P.join(self.table, other.table, on, how)
        return self._emit(out, info, [self, other])

    def append(self, other: "TrackedTable"):
        out, info = P.append(self.table, other.table)
        return self._emit(out, info, [self, other])

    def mark_sink(self) -> "TrackedTable":
        """Flag this dataset as a pipeline output (always materialized)."""
        rec = self.index.datasets[self.dataset_id]
        rec.table = self.table
        rec.is_sink = True
        return self


def track(table: Table, index: ProvenanceIndex, dataset_id: Optional[str] = None) -> TrackedTable:
    """Register ``table`` as a pipeline SOURCE and wrap it for tracking."""
    dataset_id = dataset_id or _fresh_id("src")
    index.add_source(dataset_id, table)
    return TrackedTable(table, index, dataset_id)
