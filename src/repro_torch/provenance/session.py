"""QuerySession — the planner/executor behind the lazy builder.

A session owns the physical machinery for one :class:`ProvenanceIndex`:

* the **per-op walk** (:mod:`repro_torch.core.query`), with the fused K-hop
  kernel for linear chains, and the attribute-level term walk (packed
  attribute words contracted per hop by ``bitmatmul``);
* the **composed hop-cache** (:class:`repro_torch.core.hopcache.ComposedIndex`,
  shared with every other session on the index via
  ``ProvenanceIndex.composed()``), whose relations sum over all producer
  paths of the DAG;

and picks between them per :class:`QueryPlan`:

====================  ====================================================
plan shape            strategy
====================  ====================================================
``transformations``   ``meta``: a metadata scan, no tensor touched (Q9)
``cells`` / ``how``   ``walk``: attribute planes and hop traces live on the
                      per-op pass (Q3/Q4, Q5-Q8)
record-level          ``hopcache``: a composed-relation probe when the
(Q1/Q2, Q10/Q11)      relation is already cached (resident or spilled), or
                      when the cost model estimates amortized
                      compose-then-probe under the walk; ``walk``
                      otherwise, where a linear chain goes to the fused
                      K-hop kernel when ``fused_walk`` is on
====================  ====================================================

Record-level routing is driven by :class:`repro_torch.core.costmodel.CostModel`
(shared with the hop-cache): per-pair chain statistics feed an estimated
walk cost against composition cost amortized over the cumulative probe
demand seen for the pair.  ``use_hopcache=True`` is the default, as in
``repro``; ``fused_walk=None`` resolves to True iff the index lies on a
CUDA device.  :meth:`QuerySession.run_record_terms` and
:meth:`QuerySession.run_attr_terms` walk from several seed datasets at once
(the federation's segment hooks).

``run_many`` **fuses** submitted plans that share a fuse key into ONE
pass: the probe mask stacks concatenate along the batch axis, a single
physical execution answers the union, and results split back per plan in
submission order.

A values plan (``.values()``) answers its record plan as a
:class:`RecordValues`: the batch's answer rows extracted with one host
read, and the target dataset's values at all of them from ONE
:func:`~repro_torch.core.recompute.fetch_rows` (one ``unique`` over the
union when the target is not materialized), under the span
``recompute.fetch``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import query as Q
from repro_torch.core.costmodel import constants_provenance
from repro_torch.core.recompute import fetch_rows
from repro_torch.core.spans import HOST_SYNCS, count, span
from repro_torch.provenance.plan import QueryPlan

__all__ = ["QuerySession", "RecordValues", "ProbeValues", "run_many_fused"]


class ProbeValues(NamedTuple):
    """One probe's answer to a values plan: its answer rows of the target
    (int64, ascending) and the target's values at those rows, in that
    order (float32 ``data`` and bool ``null``, one row each), with the
    target's column names."""

    rows: torch.Tensor
    data: torch.Tensor
    null: torch.Tensor
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class RecordValues:
    """A batched values plan's answer: ONE table for the whole batch.

    Probe ``b`` owns entries ``offsets[b]:offsets[b + 1]`` of ``rows``
    (int64 answer rows of the target, ascending within the probe), ``data``
    (float32) and ``null`` (bool), whose ``i``-th row holds the target's
    values at ``rows[i]``.  ``offsets`` are host ints (the counts that
    extraction reads).  Indexing gives a probe's :class:`ProbeValues`, a
    slice the probes' sub-batch (views, offsets rebased); iteration gives
    every probe's."""

    columns: Tuple[str, ...]
    rows: torch.Tensor        # (N,) int64
    data: torch.Tensor        # (N, C) float32
    null: torch.Tensor        # (N, C) bool
    offsets: Tuple[int, ...]  # (B + 1,)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, b):
        if isinstance(b, slice):
            start, stop, step = b.indices(len(self))
            if step != 1:
                raise ValueError("a RecordValues slices by consecutive probes only")
            offs = self.offsets[start: max(start, stop) + 1]
            lo, hi = offs[0], offs[-1]
            return RecordValues(self.columns, self.rows[lo:hi], self.data[lo:hi],
                                self.null[lo:hi], tuple(o - lo for o in offs))
        b = range(len(self))[b]
        lo, hi = self.offsets[b], self.offsets[b + 1]
        return ProbeValues(self.rows[lo:hi], self.data[lo:hi], self.null[lo:hi], self.columns)

    def __iter__(self):
        return (self[b] for b in range(len(self)))


def run_many_fused(plans: Sequence, run_one, execute_batched,
                   counters: Dict[str, int]) -> List:
    """The shared ``run_many`` fusion contract: group plans by
    ``fuse_key()``, concatenate each group's probe mask stacks along the
    batch axis, execute ONE batched pass per group via ``execute_batched``
    (one payload per probe), and split results back in submission order.
    Singleton groups and ``transformations`` plans go to ``run_one``.  Both
    :class:`QuerySession` and the catalog-level
    :class:`~repro_torch.provenance.federation.FederatedSession` run on
    this, so fusion cannot drift between the single-index and federated
    surfaces."""
    plans = [p if isinstance(p, QueryPlan) else p.plan() for p in plans]
    results: List = [None] * len(plans)
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(plans):
        groups.setdefault(p.fuse_key(), []).append(i)
    for key, idxs in groups.items():
        if len(idxs) == 1 or key[0] == "transformations":
            for i in idxs:
                results[i] = run_one(plans[i])
            continue
        sub = [plans[i] for i in idxs]
        fused = dataclasses.replace(
            sub[0],
            rows=torch.cat([p.rows for p in sub], dim=0),
            attrs=(torch.cat([p.attrs for p in sub], dim=0)
                   if sub[0].attrs is not None else None),
            batched=True,
        )
        counters["plans"] += len(idxs)
        counters["fused_groups"] += 1
        counters["fused_plans"] += len(idxs)
        per = execute_batched(fused)
        off = 0
        for i in idxs:
            p = plans[i]
            chunk = per[off: off + p.n_probes]
            off += p.n_probes
            results[i] = chunk if p.batched else chunk[0]
    return results


class QuerySession:
    """Planner + executor over one index; share one per serving tier."""

    def __init__(
        self,
        index,
        composed=None,
        *,
        use_hopcache: bool = True,
        fused_walk: Optional[bool] = None,
    ) -> None:
        self.index = index
        self.composed = composed if composed is not None else index.composed()
        self.use_hopcache = use_hopcache
        # tri-state: None -> the fused kernel walk iff the index is on CUDA;
        # True forces it (the plain version answers on the CPU), False disables
        self.fused_walk = fused_walk
        # shared with the hop-cache so chain statistics are computed once
        self.costmodel = self.composed.costmodel
        self.counters: Dict[str, int] = {
            "plans": 0,
            "walk": 0,
            "hopcache": 0,
            "fused_walk": 0,
            "meta": 0,
            "fused_groups": 0,
            "fused_plans": 0,
        }

    @property
    def device(self):
        """The device the session's index, and every answer, lies on."""
        return self.index.device

    # -- planning --------------------------------------------------------------
    def _plan_pairs(self, plan: QueryPlan) -> Optional[List[Tuple[str, str]]]:
        """EVERY (upstream, downstream) relation the hop-cache strategy would
        probe for this plan — two legs for the co-queries, matching their
        executors — or None when the plan cannot route through the
        hop-cache."""
        if plan.kind == "record":
            return [(plan.source, plan.target) if plan.direction == "fwd"
                    else (plan.target, plan.source)]
        if plan.kind == "co_contributory":
            if plan.via is None:
                return None  # per-probe via needs the walk's reach map
            return [(plan.source, plan.via), (plan.target, plan.via)]
        # co_dependency: back-probe (d1, d2) then forward-probe (d1, d3)
        return [(plan.anchor, plan.source), (plan.anchor, plan.target)]

    def _choose(self, plan: QueryPlan, note: bool) -> Optional[Dict[str, object]]:
        """The cost model's verdict for a cost-routable plan — summed over
        every relation leg the hopcache strategy would compose — or None
        when the decision never reaches the cost model."""
        pairs = self._plan_pairs(plan)
        if pairs is None:
            return None
        uncached = [p for p in pairs if not self.composed.contains(*p)]
        if not uncached:
            return None  # every leg already composed: contains-path decides
        if plan.rows is not None:
            count(HOST_SYNCS)
            probe_rows = float(plan.rows.sum()) / max(plan.n_probes, 1)
        else:
            probe_rows = 1.0
        legs = [
            self.costmodel.choose(
                p[0], p[1], plan.n_probes, probe_rows, note=note,
                budget_bytes=self.composed.memory_budget_bytes)
            for p in uncached
        ]
        walk = sum(leg["walk_ns"] for leg in legs)
        hopcache = sum(leg["hopcache_ns"] for leg in legs)
        return {
            "strategy": "hopcache" if hopcache < walk else "walk",
            "walk_ns": walk,
            "hopcache_ns": hopcache,
            "compose_ns": sum(leg["compose_ns"] for leg in legs),
            "demand": min(leg["demand"] for leg in legs),
            "retainable": all(leg["retainable"] for leg in legs),
            # every leg estimated implicit: the hop-cache would hold this
            # plan's relations as gather arrays, not CSRs/bitplanes
            "structured": all(bool(leg.get("structured")) for leg in legs),
            "legs": legs if len(legs) > 1 else None,
        }

    def _strategy(self, plan: QueryPlan, note: bool = True) -> str:
        if plan.kind == "transformations":
            return "meta"
        if plan.kind == "cells" or plan.how:
            return "walk"  # attr planes / hop traces live on the walk
        if not self.use_hopcache:
            return "walk"
        pairs = self._plan_pairs(plan)
        if pairs is None:
            return "walk"
        if all(self.composed.contains(*p) for p in pairs):
            return "hopcache"  # relations already composed: probe them
        return self._choose(plan, note)["strategy"]

    def explain(self, plan: QueryPlan) -> Dict[str, object]:
        """The planner's choice for ``plan``, without executing it (and
        without advancing the cost model's per-pair demand counters).
        Includes the cost model's estimates when they decided the routing.
        """
        out: Dict[str, object] = {"plan": plan.describe()}
        cost = None
        if plan.kind not in ("transformations", "cells") and not plan.how \
                and self.use_hopcache:
            cost = self._choose(plan, note=False)
        if cost is not None:
            out["strategy"] = cost["strategy"]
            out["cost"] = cost
        else:
            out["strategy"] = self._strategy(plan, note=False)
        pairs = None
        if plan.kind not in ("transformations", "cells"):
            pairs = self._plan_pairs(plan)
        if pairs is not None:
            out["residency"] = [
                {"pair": p, "state": self.composed.residency(*p) or "uncomposed"}
                for p in pairs
            ]
        # which constant set decided the routing (the defaults unless code
        # installed another through costmodel.set_constants)
        out["constants"] = constants_provenance()
        return out

    def _fused_walk_on(self) -> bool:
        if self.fused_walk is not None:
            return bool(self.fused_walk)
        return self.index.device.type == "cuda"

    # -- execution -------------------------------------------------------------
    def run(self, plan: QueryPlan):
        """Execute one plan.  Single-probe plans return one result (an int64
        index tensor, an ``(n, 2)`` int64 cell list, ``(result, hops)``, or
        a values plan's :class:`ProbeValues`); batched plans return one such
        result per probe (a values plan: one :class:`RecordValues`)."""
        with span("session.run"):
            self.counters["plans"] += 1
            if plan.kind == "transformations":
                self.counters["meta"] += 1
                return self._exec_transformations(plan)
            per = self._execute(plan)
            return per if plan.batched else per[0]

    def run_many(self, plans: Sequence) -> List:
        """Execute a batch of plans (builders or compiled plans), fusing
        same-fuse-key plans into one physical pass each
        (:func:`run_many_fused`).  Results come back in submission order."""
        return run_many_fused(plans, self.run, self._execute, self.counters)

    def run_masks(self, plan: QueryPlan) -> torch.Tensor:
        """Execute a plain record-level plan and return the RAW ``(B,
        n_target)`` boolean mask stack — no per-probe index conversion.
        Routing and counters are identical to :meth:`run` (they share
        :meth:`_record_masks`, the one record executor)."""
        if plan.kind != "record" or plan.how or plan.values:
            raise ValueError("run_masks handles plain record plans only")
        self.counters["plans"] += 1
        strategy = self._strategy(plan)
        self.counters[strategy] += 1
        return self._record_masks(plan, strategy)

    def run_record_terms(self, entry_masks: Dict[str, torch.Tensor],
                         direction: str, collect_hops: bool = False):
        """Record propagation from MULTIPLE seed datasets in one pass.

        ``entry_masks`` maps dataset id -> ``(B, n_rows)`` bool probe stacks;
        the return is the full reachable ``{dataset: (B, n) bool}`` dict
        (plus per-probe :class:`~repro_torch.core.query.Hop` traces with
        ``collect_hops``).  Always walks (hop traces live on the per-op
        pass)."""
        self.counters["plans"] += 1
        self.counters["walk"] += 1
        return Q.record_masks_terms_batch(self.index, entry_masks, direction,
                                          collect_hops=collect_hops)

    def run_attr_terms(self, entry_terms, direction: str, collect_hops: bool = False):
        """Attr-term propagation from MULTIPLE seed datasets in one pass.

        ``entry_terms`` maps dataset id -> lists of ``((B, n_rows) bool,
        (B, nw) int32)`` packed terms; the return is the full reachable
        terms dict plus per-probe hop traces (``(terms, B, hops)`` with
        ``collect_hops``, else ``(terms, B)``).  Never routes through the
        hop-cache."""
        self.counters["plans"] += 1
        self.counters["walk"] += 1
        return Q.attr_propagate_terms_batch(self.index, entry_terms, direction,
                                            collect_hops=collect_hops)

    # -- executors (each returns one payload per probe) -------------------------
    # each runs the plan up to its (B, n) mask stack or attribute terms under
    # ``session.execute``, and turns them into per-probe answers under
    # ``session.extract``
    def _execute(self, plan: QueryPlan) -> List:
        with span("session.route"):
            strategy = self._strategy(plan)
        self.counters[strategy] += 1
        if plan.kind == "record":
            return self._exec_record(plan, strategy)
        if plan.kind == "cells":
            return self._exec_cells(plan)
        if plan.kind == "co_contributory":
            return self._exec_co_contributory(plan, strategy)
        if plan.kind == "co_dependency":
            return self._exec_co_dependency(plan, strategy)
        raise ValueError(f"unexpected plan kind {plan.kind!r}")

    def _empty(self, plan: QueryPlan) -> torch.Tensor:
        return torch.zeros((plan.n_probes, self.index.datasets[plan.target].n_rows),
                           dtype=torch.bool, device=self.index.device)

    def _record_masks(self, plan: QueryPlan, strategy: str) -> torch.Tensor:
        """The one plain-record executor: (B, n_target) bool per strategy."""
        if strategy == "hopcache":
            if plan.direction == "fwd":
                return self.composed.probe_forward(plan.rows, plan.source, plan.target)
            return self.composed.probe_backward(plan.rows, plan.source, plan.target)
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

    def _exec_record(self, plan: QueryPlan, strategy: str) -> List:
        if not plan.how:
            with span("session.execute"):
                masks = self._record_masks(plan, strategy)
            if plan.values:
                return self._record_values(plan, masks)
            with span("session.extract"):
                return Q.rows_per_probe(masks)
        # how-traces only live on the walk (see _strategy)
        walker = (Q.forward_record_masks_batch if plan.direction == "fwd"
                  else Q.backward_record_masks_batch)
        with span("session.execute"):
            masks, hops = walker(self.index, plan.source, plan.rows, collect_hops=True)
            out = masks.get(plan.target, self._empty(plan))
        with span("session.extract"):
            return list(zip(Q.rows_per_probe(out), hops))

    def _record_values(self, plan: QueryPlan, masks: torch.Tensor) -> RecordValues:
        """The batch's answer rows with one host read, then the target's
        values at all of them with one recomputation."""
        with span("session.extract"):
            rows, counts = Q.rows_flat(masks)
        with span("recompute.fetch", self.index.device):
            t = fetch_rows(self.index, plan.target, rows)
        return RecordValues(tuple(t.columns), rows, t.data, t.null,
                            tuple(itertools.accumulate(counts, initial=0)))

    def _exec_cells(self, plan: QueryPlan) -> List:
        ds = self.index.datasets[plan.target]
        with span("session.execute"):
            out = Q._attr_propagate_batch(self.index, plan.source, plan.rows, plan.attrs,
                                          plan.direction, collect_hops=plan.how)
        with span("session.extract"):
            cells = Q._cells_batch(out[0].get(plan.target, []), plan.n_probes, ds.n_rows,
                                   ds.n_cols, self.index.device)
        if plan.how:
            return list(zip(cells, out[2]))
        return cells

    def _exec_co_contributory(self, plan: QueryPlan, strategy: str) -> List:
        d1, d2, via = plan.source, plan.target, plan.via
        if strategy == "hopcache":
            with span("session.execute"):
                via_masks = self.composed.probe_forward(plan.rows, d1, via)
                masks = self.composed.probe_backward(via_masks, via, d2)
            with span("session.extract"):
                return Q.rows_per_probe(masks)
        B = plan.n_probes
        with span("session.execute"):
            fwd = Q.forward_record_masks_batch(self.index, d1, plan.rows)
            groups: Dict[str, List[int]] = {}
            for b in range(B):
                v = via if via is not None else Q._pick_via(self.index, d1, d2, fwd, b)
                if v is None or v not in fwd or not Q._any(fwd[v][b]):
                    continue
                groups.setdefault(v, []).append(b)
            backs = []
            for v, bs in groups.items():
                back = Q.backward_record_masks_batch(self.index, v, fwd[v][bs])
                if d2 in back:
                    backs.append((bs, back[d2]))
        with span("session.extract"):
            empty = torch.zeros(0, dtype=torch.int64, device=self.index.device)
            results: List[torch.Tensor] = [empty] * B
            for bs, masks in backs:
                for b, row in zip(bs, Q.rows_per_probe(masks)):
                    results[b] = row
            return results

    def _exec_co_dependency(self, plan: QueryPlan, strategy: str) -> List:
        d2, d1, d3 = plan.source, plan.anchor, plan.target
        with span("session.execute"):
            if strategy == "hopcache":
                anc = self.composed.probe_backward(plan.rows, d2, d1)
                masks = self.composed.probe_forward(anc, d1, d3)
            else:
                masks = None
                back = Q.backward_record_masks_batch(self.index, d2, plan.rows)
                if d1 in back and Q._any(back[d1]):
                    fwd = Q.forward_record_masks_batch(self.index, d1, back[d1])
                    masks = fwd.get(d3)
        with span("session.extract"):
            if masks is None:
                return [torch.zeros(0, dtype=torch.int64, device=self.index.device)] \
                    * plan.n_probes
            return Q.rows_per_probe(masks)

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

    # -- introspection ----------------------------------------------------------
    def stats(self) -> Dict:
        """Planner counters + the shared hop-cache's counters
        (hits/misses/evictions/bytes); ``index`` names the owning index."""
        return {"index": self.index.name, "planner": dict(self.counters),
                "hopcache": self.composed.stats()}
