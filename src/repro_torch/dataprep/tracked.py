"""TrackedTable — the decorator-pattern capture front-end (paper §V).

Every data-prep op of :mod:`repro_torch.dataprep.ops` is exposed as a
method that (1) executes the op on the table's device, (2) hands its
CaptureInfo to the shared :class:`ProvenanceIndex`, and (3) returns a new
TrackedTable for the output dataset.  Under a recording
(:mod:`repro_torch.core.spans`) each method is the span ``capture.<method>``
on the index's device, with ``capture.op`` (the op: its data and link
arrays) and ``capture.record`` (the index's record: the provenance tensor
and schema maps) inside it.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

from repro_torch.core.opcat import CaptureInfo
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.spans import span
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
        with span("capture.record", self.index.device):
            self.index.record(
                [t.dataset_id for t in inputs],
                out_id,
                out,
                info,
                keep_output=keep_output,
                input_tables=[t.table for t in inputs],
            )
        return TrackedTable(out, self.index, out_id)

    def _track(self, name: str, op, inputs: Sequence["TrackedTable"], *args,
               **kw) -> "TrackedTable":
        """Runs ``op`` over the inputs' tables and records it: the span
        ``name`` around both, ``capture.op`` around the op alone."""
        dev = self.index.device
        with span(name, dev):
            with span("capture.op", dev):
                out, info = op(*[t.table for t in inputs], *args, **kw)
            return self._emit(out, info, inputs)

    # ---- the intercepted operations (paper Table I) ---------------------------
    def value_transform(self, col, fn, **kw):
        return self._track("capture.value_transform", P.value_transform, [self], col, fn, **kw)

    def binarize(self, col, threshold):
        return self._track("capture.binarize", P.binarize, [self], col, threshold)

    def normalize(self, cols, kind="zscore"):
        return self._track("capture.normalize", P.normalize, [self], cols, kind)

    def impute(self, cols, strategy="mean"):
        return self._track("capture.impute", P.impute, [self], cols, strategy)

    def discretize(self, col, n_bins, kind="uniform"):
        return self._track("capture.discretize", P.discretize, [self], col, n_bins, kind)

    def select_columns(self, cols):
        return self._track("capture.select_columns", P.select_columns, [self], cols)

    def drop_columns(self, cols):
        return self._track("capture.drop_columns", P.drop_columns, [self], cols)

    def filter_rows(self, mask, op_name="filter"):
        return self._track("capture.filter_rows", P.filter_rows, [self], mask, op_name)

    def undersample(self, frac, seed=0):
        return self._track("capture.undersample", P.undersample, [self], frac, seed)

    def onehot(self, col, n_values=None):
        return self._track("capture.onehot", P.onehot, [self], col, n_values)

    def string_indexer(self, col):
        return self._track("capture.string_indexer", P.string_indexer, [self], col)

    def space_transform(self, cols, proj, prefix="pc"):
        return self._track("capture.space_transform", P.space_transform, [self], cols, proj,
                           prefix)

    def oversample(self, frac, seed=0, noise=0.0):
        return self._track("capture.oversample", P.oversample, [self], frac, seed, noise)

    def join(self, other: "TrackedTable", on, how="inner"):
        return self._track("capture.join", P.join, [self, other], on, how)

    def append(self, other: "TrackedTable"):
        return self._track("capture.append", P.append, [self, other])

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
