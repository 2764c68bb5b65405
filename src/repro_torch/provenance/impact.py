"""Impact analysis over recorded provenance: erasure planning and what-if
replay on ONE shared closure engine, on the index's (or catalog's) device.

Three workloads, all driven by the same batched forward record walk
(:func:`repro_torch.core.query.record_masks_terms_batch` per index, stitched
across :class:`~repro_torch.provenance.catalog.Link` alignments per
catalog):

* **Deletion propagation / GDPR erasure** — :func:`erasure_plan`: given
  rows of a source dataset (possibly an upstream member of a
  :class:`~repro_torch.provenance.catalog.ProvCatalog`), compute the full
  downstream closure and emit a minimal, topologically ordered
  :class:`RecomputePlan`: which datasets the erasure touches and which
  must be rebuilt, which composed hop-cache entries / spill payloads /
  stitched cross-relations go stale, and an estimated rebuild cost from
  :mod:`repro_torch.core.costmodel`.  The plan is a VALUE — nothing is
  dropped until :func:`apply_invalidations` executes its invalidation list.
* **What-if replay** — :func:`whatif_replay`: perturb source rows and
  re-execute ONLY the provenance-related downstream rows through
  :func:`repro_torch.core.recompute.fetch_rows`, returning before/after
  values per affected sink row.  Contextual ops replay with their FITTED
  statistics (the §III-E recompute contract), so the deltas equal a full
  pipeline re-run whenever the perturbation leaves fitted statistics
  unchanged — and rows outside the closure never move.
* **Federated attribute lineage** rides the same multi-seed walkers
  through :class:`~repro_torch.provenance.federation.FederatedSession`.

Every closure runs as ONE batched walk per member — never a per-row loop —
so erasure planning costs the same as a single lineage query.  Row ids in
the plan values are int64 tensors on the device.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.costmodel import relation_probe_cost
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.recompute import fetch_rows
from repro_torch.dataprep.table import Table
from repro_torch.provenance.catalog import (
    FederationError,
    ProvCatalog,
    qualify,
    split_ref,
)

__all__ = [
    "DatasetImpact",
    "CacheInvalidation",
    "RecomputePlan",
    "WhatIfResult",
    "erasure_plan",
    "apply_invalidations",
    "whatif_replay",
]


# ---------------------------------------------------------------------------
# Plan values
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DatasetImpact:
    """One dataset the erasure closure reaches."""

    ref: str                  # qualified "member/dataset" (bare over an index)
    rows: torch.Tensor        # affected row ids, int64, sorted ascending
    n_rows: int               # dataset row count
    materialized: bool        # §III-E policy keeps a stored table for it
    is_sink: bool
    est_ns: float = 0.0       # estimated provenance-guided rebuild cost

    @property
    def n_affected(self) -> int:
        return int(self.rows.numel())


@dataclasses.dataclass(frozen=True)
class CacheInvalidation:
    """One cached derived artifact the erasure leaves stale.

    ``kind="composed"`` names a hop-cache entry of member/index ``scope``
    (``residency`` ``"ram"`` or ``"spilled"`` — spilled payloads are
    deleted from the on-disk store on apply); ``kind="cross"`` names a
    catalog-owned stitched cross-relation (``residency`` is the route
    mode, ``"fwd"``/``"bwd"``)."""

    scope: str                # member/index name (catalog name for "cross")
    kind: str                 # "composed" | "cross"
    src: str
    dst: str
    residency: str


@dataclasses.dataclass(frozen=True)
class RecomputePlan:
    """Minimal, topologically ordered erasure/rewrite plan.

    ``impacts`` lists every dataset the closure reaches, member-topological
    then registration (= dataflow) order, so executing deletions/rebuilds
    front-to-back never visits a dataset before its affected ancestors.
    ``invalidations`` lists every cached composed relation the rewrite
    poisons — nothing is dropped until :func:`apply_invalidations`."""

    sources: Tuple[Tuple[str, torch.Tensor], ...]   # (ref, erased rows)
    impacts: Tuple[DatasetImpact, ...]
    invalidations: Tuple[CacheInvalidation, ...]
    est_total_ns: float

    @property
    def affected(self) -> Tuple[str, ...]:
        return tuple(i.ref for i in self.impacts)

    @property
    def rebuild(self) -> Tuple[str, ...]:
        """Materialized datasets that must be rebuilt, in execution order.
        The erasure sources themselves are excluded — their rows are
        deleted, not recomputed."""
        src_refs = {ref for ref, _ in self.sources}
        return tuple(i.ref for i in self.impacts
                     if i.materialized and i.ref not in src_refs)

    def impact(self, ref: str) -> Optional[DatasetImpact]:
        for i in self.impacts:
            if i.ref == ref:
                return i
        return None

    def describe(self) -> str:
        lines = ["RecomputePlan"]
        src_refs = {r for r, _ in self.sources}
        for ref, rows in self.sources:
            lines.append(f"  erase {ref}: {rows.numel()} rows")
        for i in self.impacts:
            tag = " [rebuild]" if i.materialized and i.ref not in src_refs else ""
            lines.append(f"  -> {i.ref}: {i.n_affected}/{i.n_rows} rows{tag}")
        for inv in self.invalidations:
            lines.append(f"  drop {inv.kind} {inv.scope}: "
                         f"{inv.src}->{inv.dst} ({inv.residency})")
        lines.append(f"  est rebuild cost ~{self.est_total_ns / 1e6:.2f} ms")
        return "\n".join(lines)


def _changed_cells(before: Table, after: Table) -> torch.Tensor:
    """(n, n_cols) bool: a value moved (NaN == NaN) or its nullity did."""
    d = (before.data != after.data) & ~(torch.isnan(before.data) & torch.isnan(after.data))
    return d | (before.null != after.null)


@dataclasses.dataclass(frozen=True)
class WhatIfResult:
    """Before/after values of the sink rows a perturbation reaches."""

    source: str
    sink: str
    source_rows: torch.Tensor   # perturbed source rows (sorted, unique)
    sink_rows: torch.Tensor     # provenance-related sink rows (sorted)
    before: Table               # sink_rows under the recorded run, aligned 1:1
    after: Table                # sink_rows under the perturbed replay

    @property
    def changed(self) -> torch.Tensor:
        """(len(sink_rows),) bool — rows whose value or nullity moved."""
        return _changed_cells(self.before, self.after).any(dim=1)

    def row_deltas(self) -> List[Dict[str, Tuple[float, float]]]:
        """Per affected sink row, ``{column: (before, after)}`` for exactly
        the cells that changed (empty dict = row reached but unmoved); one
        host read of both tables."""
        d = _changed_cells(self.before, self.after).cpu().numpy()
        b, a = self.before.data.cpu().numpy(), self.after.data.cpu().numpy()
        return [{self.before.columns[j]: (float(b[i, j]), float(a[i, j]))
                 for j in np.flatnonzero(d[i])}
                for i in range(d.shape[0])]


# ---------------------------------------------------------------------------
# Closure engine
# ---------------------------------------------------------------------------
def _as_rows(rows, device) -> torch.Tensor:
    """Row ids (sequence, numpy array or tensor) -> sorted unique int64."""
    if isinstance(rows, torch.Tensor):
        t = rows.to(device=device, dtype=torch.int64).reshape(-1)
    else:
        arr = rows if isinstance(rows, np.ndarray) else np.asarray(list(rows), dtype=np.int64)
        t = torch.as_tensor(arr.astype(np.int64).reshape(-1), device=device)
    return torch.unique(t)


def _seed_mask(rows: torch.Tensor, n: int) -> torch.Tensor:
    if rows.numel():
        lo, hi = torch.aminmax(rows)
        if int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"rows out of range for dataset of {n} rows")
    mask = torch.zeros((1, n), dtype=torch.bool, device=rows.device)
    mask[0, rows] = True
    return mask


def _affected_rows(masks: Dict[str, torch.Tensor], datasets, qualify_as=None):
    """dataset -> (sorted int64 row ids) for every dataset of ``datasets``
    (in its order) whose probe-0 mask has a row set."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for ds in datasets:
        m = masks.get(ds)
        if m is None:
            continue
        rows = torch.nonzero(m[0]).reshape(-1)
        if rows.numel():
            out[qualify_as(ds) if qualify_as else ds] = rows
    return out


def _closure_index(index: ProvenanceIndex, source: str, rows: torch.Tensor
                   ) -> "OrderedDict[str, torch.Tensor]":
    """Downstream closure within one index: dataset -> affected row ids,
    in registration (= topological) order.  ONE batched walk."""
    masks = Q.record_masks_terms_batch(
        index, {source: _seed_mask(rows, index.datasets[source].n_rows)}, "fwd")
    return _affected_rows(masks, index.datasets)


def _member_topo(catalog: ProvCatalog) -> List[str]:
    """All members in link-topological order (Kahn over the link graph)."""
    indeg = {name: 0 for name in catalog.members}
    adj: Dict[str, List] = {}
    for link in catalog.links:
        adj.setdefault(split_ref(link.up)[0], []).append(link)
        indeg[split_ref(link.down)[0]] += 1
    order: List[str] = []
    ready = sorted(m for m, d in indeg.items() if d == 0)
    while ready:
        m = ready.pop(0)
        order.append(m)
        for link in adj.get(m, []):
            down = split_ref(link.down)[0]
            indeg[down] -= 1
            if indeg[down] == 0:
                ready.append(down)
    if len(order) != len(catalog.members):
        raise FederationError(
            "link graph has a cycle; impact closure needs an acyclic "
            "member graph")
    return order


def _closure_catalog(catalog: ProvCatalog, sources: Dict[str, torch.Tensor]):
    """Downstream closure across the catalog.

    Returns ``(affected, member_seeds)``: affected maps qualified ref ->
    row ids in member-topological then per-member registration order;
    member_seeds maps member name -> {entry dataset: seed row count} (the
    cost model's probe anchors).  One batched multi-seed walk per member —
    a member reached through several links is walked ONCE, seeded with
    every stitched entry at the same time."""
    entries: Dict[str, Dict[str, torch.Tensor]] = {}
    for ref, rows in sources.items():
        member_name, ds = split_ref(ref)
        if member_name not in catalog.members:
            raise FederationError(
                f"unknown index {member_name!r} in ref {ref!r} "
                f"(registered: {sorted(catalog.members)})")
        mask = _seed_mask(rows, catalog.datasets[ref].n_rows)
        ent = entries.setdefault(member_name, {})
        ent[ds] = mask if ds not in ent else ent[ds] | mask
    out_links: Dict[str, List] = {}
    for link in catalog.links:
        out_links.setdefault(split_ref(link.up)[0], []).append(link)

    affected: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    member_seeds: Dict[str, Dict[str, int]] = {}
    for name in _member_topo(catalog):
        counts = {ds: int(m.sum()) for ds, m in entries.get(name, {}).items()}
        ent = {ds: m for ds, m in entries.get(name, {}).items() if counts[ds]}
        if not ent:
            continue
        member = catalog.members[name]
        member_seeds[name] = {ds: counts[ds] for ds in ent}
        masks = member.run_record_terms(ent, "fwd")
        affected.update(_affected_rows(masks, member.datasets,
                                       lambda ds, n=name: qualify(n, ds)))
        for link in out_links.get(name, []):
            m = masks.get(split_ref(link.up)[1])
            if m is None or not bool(m.any()):
                continue
            down_name, down_ds = split_ref(link.down)
            stitched = link.stitch_down(m, catalog.datasets[link.down].n_rows)
            if bool(stitched.any()):
                d_ent = entries.setdefault(down_name, {})
                d_ent[down_ds] = stitched if down_ds not in d_ent \
                    else d_ent[down_ds] | stitched
    return affected, member_seeds


# ---------------------------------------------------------------------------
# Cache-invalidation enumeration
# ---------------------------------------------------------------------------
def _composed_invalidations(index: ProvenanceIndex, datasets, scope: str
                            ) -> List[CacheInvalidation]:
    """Stale hop-cache entries of one index — enumeration only (the cache
    is read, never created: an index that was never probed has nothing to
    invalidate)."""
    composed = index._composed
    if composed is None:
        return []
    return [CacheInvalidation(scope, "composed", src, dst, residency)
            for src, dst, residency in composed.stale_entries(datasets)]


def _cross_invalidations(catalog: ProvCatalog,
                         affected_members) -> List[CacheInvalidation]:
    """Stale catalog-owned stitched cross-relations: an entry is stale
    when its endpoints OR any link it stitched through touch an affected
    member (a mid-route rewrite poisons the composed product even when
    both endpoints survive)."""
    store = getattr(catalog, "_cross_store", None)
    if store is None:
        return []
    out = []
    for (start, end, mode), (_rel, signature) in store.entries.items():
        touched = {split_ref(start)[0], split_ref(end)[0]}
        for up, down in signature:
            touched.add(split_ref(up)[0])
            touched.add(split_ref(down)[0])
        if touched & affected_members:
            out.append(CacheInvalidation(catalog.name, "cross", start, end, mode))
    return out


def apply_invalidations(target, plan: RecomputePlan) -> int:
    """Execute a plan's invalidation list: drop stale hop-cache entries
    (deleting spilled payloads) and stale stitched cross-relations.
    Returns how many artifacts were dropped.  Idempotent — re-applying a
    plan whose entries are already gone drops nothing.  BoundaryHandle
    members are read-only capabilities: their owners' caches are never
    touched (the plan carries no invalidations for them)."""
    dropped = 0
    scopes = {inv.scope for inv in plan.invalidations if inv.kind != "cross"}
    cross = [inv for inv in plan.invalidations if inv.kind == "cross"]
    if isinstance(target, ProvCatalog):
        for name in scopes:
            index = getattr(target.members.get(name), "_index", None)
            if index is None or index._composed is None:
                continue
            affected = [split_ref(i.ref)[1] for i in plan.impacts
                        if split_ref(i.ref)[0] == name]
            dropped += len(index._composed.invalidate_datasets(affected))
        store = getattr(target, "_cross_store", None)
        if store is not None:
            for inv in cross:
                key = (inv.src, inv.dst, inv.residency)
                if key in store.entries:
                    store.drop(key)
                    dropped += 1
    elif target._composed is not None and scopes:
        dropped += len(target._composed.invalidate_datasets(
            [i.ref for i in plan.impacts]))
    return dropped


# ---------------------------------------------------------------------------
# Erasure planning
# ---------------------------------------------------------------------------
def _estimate(member, seeds: Dict[str, int], ds: str) -> float:
    """Estimated cost of a provenance-guided rebuild of ``ds``'s affected
    rows from the nearest seed, via the member's cost model (compose the
    seed→ds relation once, probe it with the seed rows)."""
    for seed, n_rows in seeds.items():
        if seed == ds or not member.path_exists(seed, ds):
            continue
        try:
            rel, compose_ns = member.relation_stats(seed, ds)
        except Exception:
            return 0.0          # capability-filtered member: owner's concern
        if rel is not None:
            return float(compose_ns) + relation_probe_cost(rel, 1, float(n_rows))
    return 0.0


def erasure_plan(target, source, rows) -> RecomputePlan:
    """Deletion-propagation plan for erasing ``rows`` of ``source``.

    ``target`` is a :class:`ProvenanceIndex` (``source`` a dataset id) or a
    :class:`ProvCatalog` (``source`` a qualified ``"member/dataset"`` ref —
    the closure crosses boundary links downstream).  The closure runs as
    one batched forward walk per index, so planning costs the same as a
    single lineage query regardless of how many rows are erased."""
    rows = _as_rows(rows, target.device)
    if isinstance(target, ProvCatalog):
        affected, member_seeds = _closure_catalog(target, {source: rows})
        impacts = []
        total = 0.0
        for ref, rws in affected.items():
            name, ds = split_ref(ref)
            rec = target.datasets[ref]
            est = 0.0
            if rec.materialized and ref != source:
                est = _estimate(target.members[name], member_seeds.get(name, {}), ds)
            total += est
            impacts.append(DatasetImpact(
                ref=ref, rows=rws, n_rows=rec.n_rows,
                materialized=bool(rec.materialized),
                is_sink=bool(getattr(rec, "is_sink", False)), est_ns=est))
        affected_members = {split_ref(r)[0] for r in affected}
        invalidations: List[CacheInvalidation] = []
        for name in affected_members:
            index = getattr(target.members[name], "_index", None)
            if index is not None:
                local = [split_ref(r)[1] for r in affected if split_ref(r)[0] == name]
                invalidations.extend(_composed_invalidations(index, local, name))
        invalidations.extend(_cross_invalidations(target, affected_members))
        return RecomputePlan(
            sources=((source, rows),), impacts=tuple(impacts),
            invalidations=tuple(invalidations), est_total_ns=total)

    index: ProvenanceIndex = target
    if source not in index.datasets:
        raise KeyError(source)
    affected = _closure_index(index, source, rows)
    impacts = []
    total = 0.0
    for ds, rws in affected.items():
        rec = index.datasets[ds]
        est = 0.0
        if rec.materialized and ds != source:
            rel, compose_ns = index.session().costmodel.composed_estimate(source, ds)
            if rel is not None:
                est = float(compose_ns) + relation_probe_cost(rel, 1, float(rows.numel()))
        total += est
        impacts.append(DatasetImpact(
            ref=ds, rows=rws, n_rows=rec.n_rows,
            materialized=rec.materialized, is_sink=rec.is_sink, est_ns=est))
    return RecomputePlan(
        sources=((source, rows),), impacts=tuple(impacts),
        invalidations=tuple(_composed_invalidations(index, list(affected), index.name)),
        est_total_ns=total)


# ---------------------------------------------------------------------------
# What-if replay
# ---------------------------------------------------------------------------
def whatif_replay(target, source, rows, patch: Dict[str, Sequence],
                  sink: str) -> WhatIfResult:
    """Perturb ``rows`` of ``source`` (``patch`` maps column -> replacement
    values aligned with ``rows``) and replay ONLY the provenance-related
    rows of ``sink``, returning before/after values.

    The replay temporarily installs a patched copy of the source table (the
    values written on the device with ``index_put_``) and demotes every
    materialized dataset inside the closure, so
    :func:`~repro_torch.core.recompute.fetch_rows` re-derives exactly the
    affected rows from the perturbed values; every recorded table object is
    restored on exit, untouched.  Contextual ops re-apply their FITTED
    statistics (the §III-E recompute contract): the result equals a full
    pipeline re-run whenever the perturbation leaves fitted statistics
    unchanged.

    Over a :class:`ProvCatalog`, ``source`` and ``sink`` must be qualified
    refs inside the SAME full-access member — value recomputation never
    leaves an index."""
    if isinstance(target, ProvCatalog):
        src_member, src_ds = split_ref(source)
        sink_member, sink_ds = split_ref(sink)
        if src_member != sink_member:
            raise FederationError(
                "what-if replay recomputes values, which never leave a "
                f"member: source is in {src_member!r}, sink in "
                f"{sink_member!r}")
        index = getattr(target.members[src_member], "_index", None)
        if index is None:
            raise FederationError(
                f"member {src_member!r} is a read-only boundary capability; "
                "what-if replay needs the full index")
        res = whatif_replay(index, src_ds, rows, patch, sink_ds)
        return dataclasses.replace(res, source=source, sink=sink)

    index = target
    dev = index.device
    rows = _as_rows(rows, dev)
    rec = index.datasets[source]
    if not rec.materialized:
        raise ValueError(f"source {source!r} is not materialized")
    if sink not in index.datasets:
        raise KeyError(sink)

    closure = _closure_index(index, source, rows)
    sink_rows = closure.get(sink, torch.zeros(0, dtype=torch.int64, device=dev))
    before = fetch_rows(index, sink, sink_rows)

    patched = rec.table.copy()
    for col, vals in patch.items():
        j = torch.full_like(rows, patched.cid(col))
        vals = torch.as_tensor(np.asarray(vals, dtype=np.float32), device=dev)
        patched.data.index_put_((rows, j), vals)
        patched.null.index_put_((rows, j), torch.zeros_like(vals, dtype=torch.bool))

    demote = [ds for ds in closure
              if ds != source and index.datasets[ds].materialized]
    saved = [(rec, rec.table)]
    saved += [(index.datasets[d], index.datasets[d].table) for d in demote]
    rec.table = patched
    for d in demote:
        index.datasets[d].table = None
    try:
        after = fetch_rows(index, sink, sink_rows)
    finally:
        for r, t in saved:
            r.table = t
    return WhatIfResult(source=source, sink=sink, source_rows=rows,
                        sink_rows=sink_rows, before=before, after=after)
