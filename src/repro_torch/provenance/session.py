"""QuerySession — the planner/executor behind the lazy builder.

A session owns the physical machinery for one :class:`ProvenanceIndex` and
picks a strategy per :class:`QueryPlan`:

====================  ====================================================
plan shape            strategy
====================  ====================================================
``transformations``   ``meta``: a metadata scan, no tensor touched (Q9)
record, no ``how``    ``walk``; a linear chain goes to the fused K-hop
                      kernel when ``fused_walk`` is on (Q1/Q2), a diamond
                      falls back to the per-op walk
record, ``how``       ``walk``: hop traces live on the per-op pass (Q5/Q6)
co-queries            ``walk`` (Q10/Q11)
====================  ====================================================

``fused_walk=None`` resolves to True iff the index lies on a CUDA device.
The composed hop-cache (``use_hopcache=True``) and attribute-level
``cells`` plans (Q3/Q4/Q7/Q8) belong to a later slice (ROADMAP A5) and
raise ``NotImplementedError``.

``run_many`` **fuses** submitted plans that share a fuse key into ONE
pass: the probe mask stacks concatenate along the batch axis, a single
physical execution answers the union, and results split back per plan in
submission order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import query as Q
from repro_torch.provenance.plan import QueryPlan

__all__ = ["QuerySession"]


def _flatnonzeros(mask_stack: torch.Tensor) -> List[torch.Tensor]:
    return [torch.nonzero(m).reshape(-1) for m in mask_stack]


class QuerySession:
    """Planner + executor over one index."""

    def __init__(self, index, *, use_hopcache: bool = False,
                 fused_walk: Optional[bool] = None) -> None:
        if use_hopcache:
            raise NotImplementedError(
                "the composed hop-cache is not ported yet (ROADMAP A5); "
                "use_hopcache=True is unavailable")
        self.index = index
        # tri-state: None -> the fused kernel walk iff the index is on CUDA;
        # True forces it (the plain version answers on the CPU), False disables
        self.fused_walk = fused_walk
        self.counters: Dict[str, int] = {
            "plans": 0,
            "walk": 0,
            "fused_walk": 0,
            "meta": 0,
            "fused_groups": 0,
            "fused_plans": 0,
        }

    def _strategy(self, plan: QueryPlan) -> str:
        if plan.kind == "transformations":
            return "meta"
        if plan.kind == "cells":
            raise NotImplementedError(
                "attribute-level (cells) plans are not ported yet (ROADMAP A5)")
        return "walk"

    def _fused_walk_on(self) -> bool:
        if self.fused_walk is not None:
            return bool(self.fused_walk)
        return self.index.device.type == "cuda"

    # -- execution -------------------------------------------------------------
    def run(self, plan: QueryPlan):
        """Execute one plan.  Single-probe plans return one result (an int64
        index tensor, or ``(records, hops)``); batched plans return one such
        result per probe."""
        self.counters["plans"] += 1
        if plan.kind == "transformations":
            self.counters["meta"] += 1
            return self._exec_transformations(plan)
        per = self._execute(plan)
        return per if plan.batched else per[0]

    def run_many(self, plans: Sequence) -> List:
        """Execute a batch of plans (builders or compiled plans), fusing
        same-fuse-key plans into one physical pass each: their probe mask
        stacks concatenate along the batch axis, one execution answers the
        union, and results split back in submission order.  Singleton groups
        and ``transformations`` plans run on their own."""
        plans = [p if isinstance(p, QueryPlan) else p.plan() for p in plans]
        results: List = [None] * len(plans)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(plans):
            groups.setdefault(p.fuse_key(), []).append(i)
        for key, idxs in groups.items():
            if len(idxs) == 1 or key[0] == "transformations":
                for i in idxs:
                    results[i] = self.run(plans[i])
                continue
            sub = [plans[i] for i in idxs]
            fused = dataclasses.replace(
                sub[0],
                rows=torch.cat([p.rows for p in sub], dim=0),
                attrs=(torch.cat([p.attrs for p in sub], dim=0)
                       if sub[0].attrs is not None else None),
                batched=True,
            )
            self.counters["plans"] += len(idxs)
            self.counters["fused_groups"] += 1
            self.counters["fused_plans"] += len(idxs)
            per = self._execute(fused)
            off = 0
            for i in idxs:
                p = plans[i]
                chunk = per[off: off + p.n_probes]
                off += p.n_probes
                results[i] = chunk if p.batched else chunk[0]
        return results

    # -- executors (each returns one payload per probe) -------------------------
    def _execute(self, plan: QueryPlan) -> List:
        strategy = self._strategy(plan)
        self.counters[strategy] += 1
        if plan.kind == "record":
            return self._exec_record(plan)
        if plan.kind == "co_contributory":
            return self._exec_co_contributory(plan)
        if plan.kind == "co_dependency":
            return self._exec_co_dependency(plan)
        raise ValueError(f"unexpected plan kind {plan.kind!r}")

    def _empty(self, plan: QueryPlan) -> torch.Tensor:
        return torch.zeros((plan.n_probes, self.index.datasets[plan.target].n_rows),
                           dtype=torch.bool, device=self.index.device)

    def _record_masks(self, plan: QueryPlan) -> torch.Tensor:
        """The plain-record executor: (B, n_target) bool."""
        if self._fused_walk_on():
            fused = Q.fused_walk_record_masks_batch(
                self.index, plan.source, plan.target, plan.rows, plan.direction)
            if fused is not None:  # non-linear chains fall through to the walk
                self.counters["fused_walk"] += 1
                return fused
        walker = (Q.forward_record_masks_batch if plan.direction == "fwd"
                  else Q.backward_record_masks_batch)
        masks = walker(self.index, plan.source, plan.rows)
        return masks.get(plan.target, self._empty(plan))

    def _exec_record(self, plan: QueryPlan) -> List:
        if not plan.how:
            return _flatnonzeros(self._record_masks(plan))
        walker = (Q.forward_record_masks_batch if plan.direction == "fwd"
                  else Q.backward_record_masks_batch)
        masks, hops = walker(self.index, plan.source, plan.rows, collect_hops=True)
        out = masks.get(plan.target, self._empty(plan))
        return list(zip(_flatnonzeros(out), hops))

    def _exec_co_contributory(self, plan: QueryPlan) -> List:
        d1, d2, via = plan.source, plan.target, plan.via
        B = plan.n_probes
        fwd = Q.forward_record_masks_batch(self.index, d1, plan.rows)
        empty = torch.zeros(0, dtype=torch.int64, device=self.index.device)
        results: List[torch.Tensor] = [empty] * B
        groups: Dict[str, List[int]] = {}
        for b in range(B):
            v = via if via is not None else Q._pick_via(self.index, d1, d2, fwd, b)
            if v is None or v not in fwd or not bool(fwd[v][b].any()):
                continue
            groups.setdefault(v, []).append(b)
        for v, bs in groups.items():
            back = Q.backward_record_masks_batch(self.index, v, fwd[v][bs])
            if d2 not in back:
                continue
            for i, b in enumerate(bs):
                results[b] = torch.nonzero(back[d2][i]).reshape(-1)
        return results

    def _exec_co_dependency(self, plan: QueryPlan) -> List:
        d2, d1, d3 = plan.source, plan.anchor, plan.target
        empty = [torch.zeros(0, dtype=torch.int64, device=self.index.device)] * plan.n_probes
        back = Q.backward_record_masks_batch(self.index, d2, plan.rows)
        if d1 not in back or not bool(back[d1].any()):
            return list(empty)
        fwd = Q.forward_record_masks_batch(self.index, d1, back[d1])
        if d3 not in fwd:
            return list(empty)
        return _flatnonzeros(fwd[d3])

    def _exec_transformations(self, plan: QueryPlan) -> List[Dict]:
        return [
            {
                "op_id": op.op_id,
                "op": op.info.op_name,
                "category": op.info.category.value,
                "contextual": op.info.contextual,
                "inputs": op.input_ids,
                "output": op.output_id,
            }
            for op in self.index.upstream_ops(plan.source)
        ]
