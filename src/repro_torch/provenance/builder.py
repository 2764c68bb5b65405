"""The fluent, lazy query builder: ``prov(index)``.

One chain spells any Table-VII query; nothing executes until ``.run()``
(or until the compiled :class:`~repro_torch.provenance.plan.QueryPlan`
from ``.plan()`` is handed to a
:class:`~repro_torch.provenance.session.QuerySession`)::

    from repro_torch.provenance import prov

    prov(index).source("D_l").rows([0, 3]).forward().to(sink).run()      # Q1
    prov(index).source(sink).rows([0]).backward().to("D_l").run()        # Q2
    ... .how()                                                           # Q5/Q6
    prov(index).source(sink).transformations().run()                     # Q9
    prov(index).source("D_l").rows([0]).co_contributory("D_r").run()     # Q10
    prov(index).source(mid).rows([0]).co_dependency("D_l", sink).run()   # Q11

Batch probes are EXPLICIT — ``.rows_batch([...])`` / ``.attrs_batch([...])``.
Probe masks are built on the index's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.provenance.plan import QueryPlan

__all__ = ["prov", "ProvQuery"]


def _single_mask(rows, n: int, what: str, device) -> torch.Tensor:
    """One probe -> (n,) bool.  Accepts a bool mask, an iterable of ints, or
    a 1-D integer array or tensor.  Never guesses batch."""
    if isinstance(rows, (np.ndarray, torch.Tensor)):
        rows = torch.as_tensor(rows).to(device)
        if rows.ndim != 1:
            raise ValueError(
                f".{what}(...) takes ONE probe; use .{what}_batch(...) for a "
                f"{rows.ndim}-D stack"
            )
        if rows.dtype == torch.bool:
            if rows.shape[0] != n:
                raise ValueError(
                    f".{what}(...): bool mask has {rows.shape[0]} entries, "
                    f"dataset has {n}"
                )
            return rows.clone()
        idx = rows.to(torch.int64)
    else:
        idx = torch.as_tensor(list(rows), dtype=torch.int64, device=device)
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[idx] = True
    return m


def _batch_masks(batch, n: int, what: str, device) -> torch.Tensor:
    """A batch of probes -> (B, n) bool.  Accepts a 2-D bool mask stack, a
    2-D integer index array, or a list/tuple of probe sets."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        batch = torch.as_tensor(batch).to(device)
        if batch.ndim != 2:
            raise ValueError(
                f".{what}_batch(...) takes a batch; use .{what}(...) for a "
                "single probe"
            )
        if batch.dtype == torch.bool:
            if batch.shape[1] != n:
                raise ValueError(
                    f".{what}_batch(...): mask stack is (B, {batch.shape[1]}), "
                    f"dataset has {n}"
                )
            return batch.clone()
        out = torch.zeros((batch.shape[0], n), dtype=torch.bool, device=device)
        out[torch.arange(batch.shape[0], device=device)[:, None], batch.to(torch.int64)] = True
        return out
    if not isinstance(batch, (list, tuple)):
        raise ValueError(f".{what}_batch(...) takes a list of probe sets")
    if len(batch) == 0:
        return torch.zeros((0, n), dtype=torch.bool, device=device)
    return torch.stack([_single_mask(p, n, what, device) for p in batch], dim=0)


class ProvQuery:
    """Mutable fluent builder over one :class:`ProvenanceIndex`.

    Every method returns ``self``; ``.plan()`` validates + compiles to the
    immutable :class:`QueryPlan`; ``.run(session=None)`` executes it through
    the given (default: the index's shared) :class:`QuerySession`.
    """

    def __init__(self, index) -> None:
        self._index = index
        self._source: Optional[str] = None
        self._rows = None
        self._rows_batched = False
        self._attrs = None
        self._attrs_batched = False
        self._direction: Optional[str] = None
        self._target: Optional[str] = None
        self._how = False
        self._kind: Optional[str] = None
        self._via: Optional[str] = None
        self._anchor: Optional[str] = None

    def _known(self, dataset_id: str) -> str:
        if dataset_id not in self._index.datasets:
            raise KeyError(f"unknown dataset {dataset_id!r}")
        return dataset_id

    # -- probe anchoring ------------------------------------------------------
    def source(self, dataset_id: str) -> "ProvQuery":
        """The dataset the row probe lives in (probe origin, either end)."""
        self._source = self._known(dataset_id)
        return self

    def rows(self, rows) -> "ProvQuery":
        """ONE probe set: iterable of row indices, 1-D int array, or a 1-D
        bool mask.  Result is single-shaped (one index tensor)."""
        self._rows, self._rows_batched = rows, False
        return self

    def rows_batch(self, batch) -> "ProvQuery":
        """A BATCH of probe sets (list of sets / 2-D mask or index stack).
        Result is batch-shaped (one entry per probe), answered in one pass."""
        self._rows, self._rows_batched = batch, True
        return self

    def attrs(self, attrs) -> "ProvQuery":
        """ONE attribute probe (makes the plan attribute-level, Q3/Q4/Q7/Q8)."""
        self._attrs, self._attrs_batched = attrs, False
        return self

    def attrs_batch(self, batch) -> "ProvQuery":
        """Per-probe attribute sets; must align 1:1 with ``.rows_batch``."""
        self._attrs, self._attrs_batched = batch, True
        return self

    # -- direction / endpoints -----------------------------------------------
    def forward(self) -> "ProvQuery":
        self._direction = "fwd"
        return self

    def backward(self) -> "ProvQuery":
        self._direction = "bwd"
        return self

    def to(self, dataset_id: str) -> "ProvQuery":
        """The answer dataset."""
        self._target = self._known(dataset_id)
        return self

    def how(self) -> "ProvQuery":
        """Also collect the per-op :class:`Hop` trace (Q5/Q6)."""
        self._how = True
        return self

    # -- non record/cells kinds ----------------------------------------------
    def transformations(self) -> "ProvQuery":
        """Q9: every transformation applied to ``.source`` (metadata only)."""
        self._kind = "transformations"
        return self

    def co_contributory(self, d2: str, via: Optional[str] = None) -> "ProvQuery":
        """Q10: records of ``d2`` used together with the probe rows to create
        new records (in ``via``; default — the per-probe last common
        descendant)."""
        self._kind = "co_contributory"
        self._target = d2
        self._via = via
        return self

    def co_dependency(self, d1: str, d3: str) -> "ProvQuery":
        """Q11: records of ``d3`` lineage-dependent on the ``d1`` records
        that generated the probe rows."""
        self._kind = "co_dependency"
        self._anchor = d1
        self._target = d3
        return self

    # -- compile / execute -----------------------------------------------------
    def plan(self) -> QueryPlan:
        """Validate and compile to the immutable :class:`QueryPlan` IR."""
        if self._source is None:
            raise ValueError("missing .source(dataset)")
        kind = self._kind
        if kind is None:
            kind = "cells" if self._attrs is not None else "record"
        if kind == "transformations":
            return QueryPlan(kind=kind, source=self._source)

        dev = self._index.device
        ds = self._index.datasets[self._source]
        if self._rows is None:
            raise ValueError("missing .rows(...) / .rows_batch(...)")
        if self._rows_batched:
            rows = _batch_masks(self._rows, ds.n_rows, "rows", dev)
        else:
            rows = _single_mask(self._rows, ds.n_rows, "rows", dev)[None, :]
        B = rows.shape[0]

        attrs = None
        if self._attrs is not None:
            if self._attrs_batched:
                if not self._rows_batched:
                    raise ValueError(".attrs_batch(...) needs .rows_batch(...)")
                attrs = _batch_masks(self._attrs, ds.n_cols, "attrs", dev)
            else:
                one = _single_mask(self._attrs, ds.n_cols, "attrs", dev)
                attrs = one[None, :].expand(B, ds.n_cols).clone()
        elif kind == "cells":
            raise ValueError("cells plan needs .attrs(...)")

        if kind in ("record", "cells"):
            if self._direction is None:
                raise ValueError("missing .forward() / .backward()")
            if self._target is None:
                raise ValueError("missing .to(dataset)")

        return QueryPlan(
            kind=kind,
            source=self._source,
            target=self._target,
            direction=self._direction or "fwd",
            rows=rows,
            attrs=attrs,
            how=self._how,
            batched=self._rows_batched,
            via=self._via,
            anchor=self._anchor,
        )

    def run(self, session=None):
        """Execute through ``session`` (default: the index's shared session)."""
        if session is None:
            session = self._index.session()
        return session.run(self.plan())


def prov(index) -> ProvQuery:
    """Entry point: a fresh lazy builder over a
    :class:`~repro_torch.core.pipeline.ProvenanceIndex`."""
    return ProvQuery(index)
