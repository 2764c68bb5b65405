"""The QueryPlan IR — the compiled form of one provenance query.

The fluent builder (:mod:`repro_torch.provenance.builder`) normalizes every
probe into this explicit intermediate representation; the planner/executor
(:class:`repro_torch.provenance.session.QuerySession`) then chooses the
physical strategy (per-op walk or the fused K-hop kernel) per plan, and
fuses plans that share a fuse key into one pass.

A plan is *data*, not behaviour: row/attr probes are held as normalized
boolean mask stacks of shape ``(B, n)`` on the index's device, so that
stacking two plans' probes is plain ``torch.cat`` — the whole fusion story
rests on that.

Plan kinds and their Table-VII queries:

=================  ==========================================================
kind               covers
=================  ==========================================================
``record``         Q1/Q2 (``how=False``), Q5/Q6 (``how=True``)
``cells``          Q3/Q4 (``how=False``), Q7/Q8 (``how=True``)
``transformations``  Q9 (metadata only)
``co_contributory``  Q10 (``via`` optional — per-probe default otherwise)
``co_dependency``    Q11 (``anchor`` = the shared ancestor dataset d1)
=================  ==========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QueryPlan", "PLAN_KINDS"]

PLAN_KINDS = (
    "record",
    "cells",
    "transformations",
    "co_contributory",
    "co_dependency",
)


@dataclasses.dataclass(frozen=True, eq=False)
class QueryPlan:
    """One compiled provenance query.

    ``rows`` / ``attrs`` are normalized ``(B, n)`` boolean mask stacks
    (``B == 1`` for single probes; ``batched`` records whether the caller
    asked for batch-shaped results).  ``eq`` is disabled — plans carry
    tensors; identity is the right notion for the planner.
    """

    kind: str                           # one of PLAN_KINDS
    source: str                         # dataset the row probe lives in
    target: Optional[str] = None        # answer dataset (d2 for Q10, d3 for Q11)
    direction: str = "fwd"              # "fwd" | "bwd" (record / cells)
    rows: Optional[torch.Tensor] = None   # (B, n_source) bool
    attrs: Optional[torch.Tensor] = None  # (B, n_source_cols) bool (cells only)
    how: bool = False                   # collect Hop traces (Q5-Q8)
    batched: bool = False               # caller asked for batch-shaped results
    via: Optional[str] = None           # Q10 meeting dataset (None = per-probe)
    anchor: Optional[str] = None        # Q11 shared-ancestor dataset (d1)

    def __post_init__(self) -> None:
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r}")
        if self.direction not in ("fwd", "bwd"):
            raise ValueError(f"unknown direction {self.direction!r}")
        if self.kind != "transformations" and self.rows is None:
            raise ValueError(f"{self.kind} plan needs a row probe")
        if self.kind == "cells" and self.attrs is None:
            raise ValueError("cells plan needs an attr probe")
        if self.kind in ("record", "cells") and self.target is None:
            raise ValueError(f"{self.kind} plan needs a target dataset (.to)")
        if self.kind == "co_dependency" and (
            self.anchor is None or self.target is None
        ):
            raise ValueError("co_dependency plan needs anchor (d1) and target (d3)")
        if self.kind == "co_contributory" and self.target is None:
            raise ValueError("co_contributory plan needs a target dataset (d2)")
        if self.how and self.kind not in ("record", "cells"):
            raise ValueError(f"how-provenance is undefined for {self.kind} plans")
        if (
            self.rows is not None
            and self.attrs is not None
            and self.rows.shape[0] != self.attrs.shape[0]
        ):
            raise ValueError(
                f"row batch ({self.rows.shape[0]}) and attr batch "
                f"({self.attrs.shape[0]}) disagree"
            )

    # -- planner handles ------------------------------------------------------
    @property
    def n_probes(self) -> int:
        return 0 if self.rows is None else int(self.rows.shape[0])

    def fuse_key(self) -> Tuple:
        """Plans with equal keys answer from ONE fused physical pass.

        Everything except the probe masks participates: kind, endpoints,
        direction, how, attr-presence, via/anchor.
        """
        return (
            self.kind,
            self.direction,
            self.source,
            self.target,
            self.via,
            self.anchor,
            self.how,
            self.attrs is not None,
        )
