"""FederatedSession — plan splitting and mask stitching across a catalog.

The federated twin of :class:`~repro_torch.provenance.session.QuerySession`,
with the same surface (``run`` / ``run_many`` / ``explain`` / ``stats``)
over a :class:`~repro_torch.provenance.catalog.ProvCatalog` instead of one
index.  Every mask stack and relation stays on the catalog's device from
segment to segment.

Execution model — record-level plans are *linear* in the probe mask (record
propagation distributes over union), so a cross-index query factors into
per-member segments joined by link stitches:

1. **Route.**  Member-level reachability over the link graph (a DAG; cycles
   raise).  Only members on some ``source``-member → ``target``-member path
   participate.
2. **Propagate.**  Per member, in link-topological order: every entry mask
   (the original probe, or masks stitched in over incoming links) advances
   to every needed exit dataset through ONE record plan on the owning
   member's own cost-model-driven ``QuerySession`` — the member's
   ``ComposedIndex`` stays private, and its walk / fused-walk / hop-cache
   routing applies per segment.  Exits reached from several entries UNION
   (exactly what a merged index's walk would do), so diamonds that span the
   boundary answer exactly.
3. **Stitch.**  ``(B, n)`` mask stacks cross each link through its row
   alignment (:meth:`~repro_torch.provenance.catalog.Link.stitch_down` /
   ``stitch_up``), then keep propagating.

``run_many`` fuses plans sharing a fuse key exactly like ``QuerySession``
(:func:`~repro_torch.provenance.session.run_many_fused`), so a batch of
cross-index traces still packs into ONE pass per member segment.

**Cross-boundary composed relations.**  For a HOT route the federation
memoizes the fully STITCHED relation — each member's composed relation
(read through :meth:`relation_csr`, the probe capability a
``BoundaryHandle`` grants) chained through the link alignment matrices and
unioned over parallel link paths, as torch sparse CSR products on the
device — so a sustained cross-index workload probes ONE relation, like a
merged index would.  The cache lives in a CATALOG-owned :class:`_CrossStore`
shared by every session over the catalog, is bounded by
``cross_budget_bytes`` (LRU, bytes counted as ``repro`` counts its scipy
CSR: float32 values, int32 indices), and drops a route when the link set
changes what it stitches through.

*When* a route composes is decided by the cost model
(:func:`repro_torch.core.costmodel.cross_route_choose`) from per-segment
relation statistics (host integers from shapes and counts, never a read
of a mask); an explicit ``cross_min_demand=`` integer keeps the legacy
fixed demand floor for that session instead.

Plan kinds: ``record`` (fwd/bwd) and the co-queries (explicit ``via`` for
Q10) split into per-member record segments.  ``cells`` / ``how`` plans run
as per-member TERM walks (:meth:`QuerySession.run_attr_terms` /
``run_record_terms``: every boundary entry of a member seeds ONE pass, so
hop traces match a merged index's single walk): row masks cross each link
through its row alignment and attribute masks re-align BY COLUMN NAME
between the two boundary datasets (columns absent on the far side drop).
Each crossing adds a synthetic ``category="link"`` hop to how-traces.
``transformations`` is single-ref and delegates.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.compose import binary_csr, csr_pairs, csr_from_pairs
from repro_torch.core.costmodel import RelStats, cross_route_choose
from repro_torch.core.provtensor import pack_bitplane, unpack_bitplane
from repro_torch.core.query import Hop, _cells_batch, rows_per_probe
from repro_torch.provenance.catalog import (
    CapabilityError,
    FederationError,
    Link,
    ProvCatalog,
    split_ref,
)
from repro_torch.provenance.plan import QueryPlan
from repro_torch.provenance.session import run_many_fused

__all__ = ["FederatedSession"]

DEFAULT_CROSS_BUDGET_BYTES = 64 << 20


def _csr32(rel: torch.Tensor) -> torch.Tensor:
    """A sparse product or sum with int32 indices again (values kept)."""
    return torch.sparse_csr_tensor(
        rel.crow_indices().to(torch.int32), rel.col_indices().to(torch.int32),
        rel.values(), size=tuple(rel.shape), check_invariants=False)


def _transpose(rel: torch.Tensor) -> torch.Tensor:
    """The transposed binary relation as CSR (int32 indices, float32 ones)."""
    rows, cols = csr_pairs(rel)
    return csr_from_pairs(cols, rows, rel.shape[1], rel.shape[0])


class _CrossStore:
    """Catalog-owned stitched cross-relation cache + route demand.

    One store per :class:`ProvCatalog`, shared by every
    :class:`FederatedSession` over it — the serving tier's sessions, ad-hoc
    audit sessions and benches all see the same hot routes.  All mutation
    happens inside session calls, which callers serialize per catalog."""

    def __init__(self, budget_bytes: int = DEFAULT_CROSS_BUDGET_BYTES) -> None:
        self.budget_bytes = int(budget_bytes)
        # route key (start, end, mode) -> (relT csr, crossed-link signature)
        self.entries: "OrderedDict[Tuple[str, str, str], tuple]" = OrderedDict()
        self.nbytes = 0
        self.failed: set = set()        # routes not worth/able to compose
        self.demand: Dict[Tuple[str, str, str], int] = {}
        self.links_version: Optional[int] = None

    @staticmethod
    def rel_nbytes(rel: torch.Tensor) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (rel.values(), rel.col_indices(), rel.crow_indices())))

    def get(self, key):
        entry = self.entries.get(key)
        if entry is None:
            return None
        self.entries.move_to_end(key)
        return entry

    def put(self, key, rel, signature: frozenset) -> bool:
        nbytes = self.rel_nbytes(rel)
        if nbytes > self.budget_bytes:
            return False                # larger than the budget: keep segments
        old = self.entries.pop(key, None)
        if old is not None:
            self.nbytes -= self.rel_nbytes(old[0])
        self.entries[key] = (rel, signature)
        self.nbytes += nbytes
        while self.nbytes > self.budget_bytes and len(self.entries) > 1:
            _, (evicted, _) = self.entries.popitem(last=False)
            self.nbytes -= self.rel_nbytes(evicted)
        return True

    def drop(self, key) -> None:
        entry = self.entries.pop(key, None)
        if entry is not None:
            self.nbytes -= self.rel_nbytes(entry[0])


@dataclasses.dataclass
class _Segment:
    """One intra-member record hop of a federated route (explain unit)."""

    member: str
    source: str             # unqualified, within the member
    target: str
    direction: str          # "fwd" | "bwd"


# ---------------------------------------------------------------------------
# Traversal semirings: ONE route walk (_traverse), three value domains.
# Keeping mask propagation, relation composition and dry routing on the
# same traversal is what guarantees the hot (stitched-relation) path can
# never answer differently from the cold (segment) path.
# ---------------------------------------------------------------------------
class _DryOps:
    """Reachability only: no member work, values are the literal True."""

    def extend(self, member, value, src, dst, direction):
        return True

    def union(self, a, b):
        return True

    def settle(self, acc):
        return acc

    def stitch(self, link, value, reverse, n_up, n_down):
        return True


class _MaskOps:
    """(B, n) bool mask stacks through each member's QuerySession."""

    def __init__(self, session: "FederatedSession") -> None:
        self.session = session

    def extend(self, member, value, src, dst, direction):
        self.session.counters["segments"] += 1
        return member.run_masks(QueryPlan(
            kind="record", source=src, target=dst, direction=direction,
            rows=value, batched=True))

    def union(self, a, b):
        return a | b

    def settle(self, acc):
        return acc

    def stitch(self, link, value, reverse, n_up, n_down):
        return link.stitch_up(value, n_up) if reverse \
            else link.stitch_down(value, n_down)


class _RelOps:
    """(n_start, n_ds) torch sparse CSR relations: the stitched
    cross-relation composer.  ``extend`` chains each member's composed
    relation (``relation_csr`` — the capability-granted read), ``stitch``
    applies the link's alignment matrix, ``settle`` re-binarizes
    accumulated path counts (the (OR, AND) semiring's union)."""

    def extend(self, member, value, src, dst, direction):
        if direction == "bwd":
            return _csr32(value @ _transpose(member.relation_csr(dst, src)))
        return _csr32(value @ member.relation_csr(src, dst))

    def union(self, a, b):
        return _csr32(a + b)

    def settle(self, acc):
        return binary_csr(acc.crow_indices(), acc.col_indices(), acc.shape[0], acc.shape[1])

    def stitch(self, link, value, reverse, n_up, n_down):
        A = link.matrix(n_up, n_down)
        return _csr32(value @ (_transpose(A) if reverse else A))


class FederatedSession:
    """Planner/executor over a :class:`ProvCatalog`; share one per catalog
    (``catalog.session()``)."""

    def __init__(self, catalog: ProvCatalog, *,
                 cross_min_demand: Optional[int] = None,
                 cross_budget_bytes: Optional[int] = None) -> None:
        self.catalog = catalog
        self.device = catalog.device
        # cross-boundary composed relations: route -> stitched CSR, in the
        # catalog-owned store every session over this catalog shares
        store = getattr(catalog, "_cross_store", None)
        if store is None:
            store = _CrossStore(cross_budget_bytes
                                if cross_budget_bytes is not None
                                else DEFAULT_CROSS_BUDGET_BYTES)
            store.links_version = len(catalog.links)
            catalog._cross_store = store
        elif cross_budget_bytes is not None:
            store.budget_bytes = int(cross_budget_bytes)
        self._store = store
        # None = the cost-model gate (cross_route_choose); an explicit int
        # keeps the legacy fixed demand floor for this session
        self.cross_min_demand = (None if cross_min_demand is None
                                 else int(cross_min_demand))
        self.counters: Dict[str, int] = {
            "plans": 0,
            "single_index": 0,
            "federated": 0,
            "segments": 0,
            "links_crossed": 0,
            "fused_groups": 0,
            "fused_plans": 0,
            "cross_composes": 0,
            "cross_probes": 0,
        }

    # -- ref plumbing ----------------------------------------------------------
    def _member_name(self, ref: str) -> str:
        name, _ = split_ref(ref)
        if name not in self.catalog.members:
            raise FederationError(
                f"unknown index {name!r} in ref {ref!r} "
                f"(registered: {sorted(self.catalog.members)})"
            )
        return name

    def _plan_members(self, plan: QueryPlan) -> List[str]:
        names = []
        for ref in plan.refs():
            n = self._member_name(ref)
            if n not in names:
                names.append(n)
        return names

    def _unqualified(self, plan: QueryPlan) -> QueryPlan:
        strip = lambda r: None if r is None else split_ref(r)[1]  # noqa: E731
        return dataclasses.replace(
            plan, source=strip(plan.source), target=strip(plan.target),
            via=strip(plan.via), anchor=strip(plan.anchor),
        )

    def _n_rows(self, ref: str) -> int:
        return self.catalog.datasets[ref].n_rows

    def _empty(self, B: int, ref: str) -> torch.Tensor:
        return torch.zeros((B, self._n_rows(ref)), dtype=torch.bool, device=self.device)

    def _link_rows(self, link: Link) -> Tuple[int, int]:
        return self._n_rows(link.up), self._n_rows(link.down)

    @staticmethod
    def _out_links(links: List[Link], reverse: bool) -> Dict[str, List[Link]]:
        """Links per member they LEAVE in traversal direction."""
        out: Dict[str, List[Link]] = {}
        for link in links:
            out.setdefault(split_ref(link.down if reverse else link.up)[0], []).append(link)
        return out

    # -- routing ---------------------------------------------------------------
    def _route(self, m0: str, m1: str, reverse: bool
               ) -> Optional[Tuple[List[str], List[Link]]]:
        """Members in topological traversal order + the links on some
        ``m0`` → ``m1`` path, or None when no link path exists."""
        adj = self._out_links(self.catalog.links, reverse)

        def _next(link: Link) -> str:
            return split_ref(link.up if reverse else link.down)[0]

        # members reachable from m0 / co-reachable to m1
        fwd = {m0}
        frontier = [m0]
        while frontier:
            m = frontier.pop()
            for link in adj.get(m, []):
                n = _next(link)
                if n not in fwd:
                    fwd.add(n)
                    frontier.append(n)
        if m1 not in fwd:
            return None
        radj: Dict[str, List[str]] = {}
        for m, links in adj.items():
            for link in links:
                radj.setdefault(_next(link), []).append(m)
        bwd = {m1}
        frontier = [m1]
        while frontier:
            m = frontier.pop()
            for p in radj.get(m, []):
                if p not in bwd:
                    bwd.add(p)
                    frontier.append(p)
        relevant = fwd & bwd
        links = [l for m in relevant for l in adj.get(m, [])  # noqa: E741
                 if _next(l) in relevant]
        # Kahn topo order over the relevant members
        indeg = {m: 0 for m in relevant}
        for link in links:
            indeg[_next(link)] += 1
        order, ready = [], sorted(m for m, d in indeg.items() if d == 0)
        while ready:
            m = ready.pop(0)
            order.append(m)
            for link in adj.get(m, []):
                n = _next(link)
                if n in indeg:
                    indeg[n] -= 1
                    if indeg[n] == 0:
                        ready.append(n)
        if len(order) != len(relevant):
            raise FederationError(
                f"link graph has a cycle through {sorted(relevant)}; "
                "federated routing needs an acyclic member graph"
            )
        return order, links

    # -- the shared route traversal --------------------------------------------
    def _traverse(self, start_ref: str, end_ref: str, mode: str,
                  order: List[str], links: List[Link], ops, init):
        """Walk the route in member-topological order, propagating a VALUE
        (mask stack, relation, or dry True) from ``start_ref`` to
        ``end_ref``: per member, every entry value advances to every
        needed exit through ``ops.extend`` (exits reached from several
        entries ``ops.union``), then crosses each outgoing link through
        ``ops.stitch``.  Returns ``(answer, segments, crossed)``.

        The ONE traversal behind live mask propagation, stitched
        cross-relation composition, AND dry routing (explain / invalidation
        signatures)."""
        m0, d0 = split_ref(start_ref)
        m1, d1 = split_ref(end_ref)
        reverse = mode == "bwd"
        direction = "bwd" if reverse else "fwd"
        out_links = self._out_links(links, reverse)

        entries: Dict[str, Dict[str, object]] = {m0: {d0: init}}
        segments: List[_Segment] = []
        crossed: List[Link] = []
        answer = None
        for m in order:
            ent = entries.pop(m, None)
            if not ent:
                continue
            member = self.catalog.members[m]
            # exit datasets this member must produce values at
            exits: List[str] = []
            for link in out_links.get(m, []):
                near = split_ref(link.down if reverse else link.up)[1]
                if near not in exits:
                    exits.append(near)
            if m == m1 and d1 not in exits:
                exits.append(d1)
            exit_vals: Dict[str, object] = {}
            for x in exits:
                acc = None
                for e, val in ent.items():
                    if e == x:
                        contrib = val       # direct pass-through
                    else:
                        has_path = member.path_exists(x, e) if reverse \
                            else member.path_exists(e, x)
                        if not has_path:
                            continue
                        segments.append(_Segment(m, e, x, direction))
                        contrib = ops.extend(member, val, e, x, direction)
                    acc = contrib if acc is None else ops.union(acc, contrib)
                if acc is not None:
                    exit_vals[x] = ops.settle(acc)
            if m == m1:
                answer = exit_vals.get(d1)
            for link in out_links.get(m, []):
                near_ref, far_ref = (
                    (link.down, link.up) if reverse else (link.up, link.down))
                near_ds = split_ref(near_ref)[1]
                far_m, far_ds = split_ref(far_ref)
                val = exit_vals.get(near_ds)
                if val is None:
                    continue
                crossed.append(link)
                n_up, n_down = self._link_rows(link)
                stitched = ops.stitch(link, val, reverse, n_up, n_down)
                dest = entries.setdefault(far_m, {})
                prev = dest.get(far_ds)
                dest[far_ds] = stitched if prev is None \
                    else ops.union(prev, stitched)
        return answer, segments, crossed

    # -- cross-boundary composed relations -------------------------------------
    def _crossed_signature(self, key) -> Optional[frozenset]:
        """The set of links a route would actually STITCH THROUGH right
        now, from a dry traversal (path_exists checks only, no tensor
        work) — the stitched relation depends on exactly these."""
        start, end, mode = key
        try:
            route = self._route(split_ref(start)[0], split_ref(end)[0],
                                reverse=(mode == "bwd"))
        except FederationError:         # e.g. a new link formed a cycle
            return None
        if route is None:
            return None
        _, _, crossed = self._traverse(start, end, mode, route[0], route[1],
                                       _DryOps(), True)
        return frozenset((link.up, link.down) for link in crossed)

    # -- views over the shared store (tests/introspection) ---------------------
    @property
    def _cross(self):
        return self._store.entries

    @property
    def _cross_bytes(self) -> int:
        return self._store.nbytes

    @property
    def _cross_failed(self) -> set:
        return self._store.failed

    @property
    def _route_demand(self) -> Dict[Tuple[str, str, str], int]:
        return self._store.demand

    @property
    def cross_budget_bytes(self) -> int:
        return self._store.budget_bytes

    def _cross_sync(self) -> None:
        """Reconcile stitched relations after the LINK set changed: drop
        only the routes whose crossed-link signature a fresh dry traversal
        no longer reproduces (a new link landing on a brand-new dataset no
        cached route reaches keeps every hot relation).  Member-side writes
        never invalidate (append-only DAGs, one producer per dataset)."""
        store = self._store
        if len(self.catalog.links) == store.links_version:
            return
        store.links_version = len(self.catalog.links)
        store.failed.clear()        # a new link may make a route viable
        for key in list(store.entries):
            _, signature = store.entries[key]
            if self._crossed_signature(key) != signature:
                store.drop(key)

    # -- the cost-model compose gate -------------------------------------------
    def _route_hop_stats(self, start_ref: str, end_ref: str, mode: str,
                         order: List[str], links: List[Link]):
        """Oriented per-hop :class:`RelStats` for a route, in traversal
        order (member composed relations + link alignment matrices), plus
        the summed member one-time compose estimate.  Statistics only —
        the ``relation_stats`` capability read and host counts, no tensor
        work.  A hop that cannot be priced contributes ``None`` (the gate
        then falls back to the legacy demand floor)."""
        _, segments, crossed = self._traverse(
            start_ref, end_ref, mode, order, links, _DryOps(), True)
        per_member: Dict[str, List] = {}
        for seg in segments:
            per_member.setdefault(seg.member, []).append(seg)
        reverse = mode == "bwd"
        out_links = self._out_links(crossed, reverse)
        stats: List[Optional[RelStats]] = []
        compose_ns = 0.0
        for m in order:
            member = self.catalog.members[m]
            for seg in per_member.get(m, []):
                pair = ((seg.target, seg.source) if seg.direction == "bwd"
                        else (seg.source, seg.target))
                try:
                    rel, ns = member.relation_stats(*pair)
                except (AttributeError, CapabilityError, KeyError):
                    rel, ns = None, 0.0
                if rel is not None and seg.direction == "bwd":
                    rel = RelStats(rel.cols, rel.rows, rel.nnz, rel.structured)
                stats.append(rel)
                compose_ns += ns
            for link in out_links.get(m, []):
                n_up, n_down = self._link_rows(link)
                nnz = n_up if link.alignment is None else link.n_linked
                rows, cols = (n_down, n_up) if reverse else (n_up, n_down)
                stats.append(RelStats(rows, cols, nnz, structured=True))
        return stats, compose_ns

    def _cross_should_compose(self, key, order: List[str], links: List[Link],
                              demand: int, n_probes: int) -> bool:
        """Whether the route should flip from segment execution to the
        stitched relation NOW.  Sessions with an explicit
        ``cross_min_demand=`` keep the fixed demand floor; otherwise the
        cost model prices both (:func:`cross_route_choose`)."""
        if self.cross_min_demand is not None:
            return demand >= self.cross_min_demand
        start_ref, end_ref, mode = key
        stats, compose_ns = self._route_hop_stats(start_ref, end_ref, mode,
                                                  order, links)
        verdict = cross_route_choose(stats, compose_ns, n_probes, demand,
                                     budget_bytes=self._store.budget_bytes)
        return verdict["strategy"] == "stitched"

    def _compose_cross(self, start_ref: str, end_ref: str, mode: str,
                       order: List[str], links: List[Link]) -> Optional[torch.Tensor]:
        """The stitched ``(n_start, n_end)`` relation for a cross-member
        route, as torch sparse CSR (via the :class:`_RelOps` semiring on the
        shared traversal): ``M[i, j] = 1`` iff start row ``i`` propagates
        to end row ``j`` — so a probe is ONE sparse product, the
        merged-index cost."""
        n0 = self._n_rows(start_ref)
        i = torch.arange(n0 + 1, dtype=torch.int32, device=self.device)
        init = binary_csr(i, i[:-1], n0, n0)
        answer, _, _ = self._traverse(start_ref, end_ref, mode, order, links,
                                      _RelOps(), init)
        return answer

    @staticmethod
    def _cross_probe(relT: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """(B, n_start) bool through the stitched relation -> (B, n_end).

        ``relT`` is cached TRANSPOSED (``(n_end, n_start)`` CSR) so the
        probe is one CSR × dense product, the access pattern of a merged
        index's composed CSR backward probe."""
        return (relT @ masks.to(torch.float32).T).T > 0

    # -- the core: federated record propagation --------------------------------
    def _propagate(self, start_ref: str, end_ref: str,
                   masks: Optional[torch.Tensor], mode: str,
                   order: Optional[List[str]] = None,
                   links: Optional[List[Link]] = None):
        """Propagate ``(B, n_start)`` probe masks from ``start_ref`` to
        ``end_ref`` along dataflow (``mode="fwd"``) or against it
        (``mode="bwd"``).  With ``masks=None`` runs DRY: no member plans
        execute, and the (segments, links) a live run would use come back
        instead — ``explain`` uses this."""
        dry = masks is None
        m0, _ = split_ref(start_ref)
        m1, _ = split_ref(end_ref)
        if order is None:
            if m0 == m1:
                order, links = [m0], []
            else:
                route = self._route(m0, m1, reverse=(mode == "bwd"))
                if route is None:
                    return None if dry else self._empty(masks.shape[0], end_ref)
                order, links = route
        if dry:
            _, segments, crossed = self._traverse(
                start_ref, end_ref, mode, order, links, _DryOps(), True)
            return segments, crossed
        if m0 != m1:
            # hot-route fast path: probe the stitched cross relation once,
            # composing it when cumulative demand has paid for it.  A route
            # that failed to compose (no path, or over budget) is memoized
            # as failed so it never re-pays the compose per probe.
            self._cross_sync()
            store = self._store
            key = (start_ref, end_ref, mode)
            entry = store.get(key)
            if entry is None and key not in store.failed:
                demand = store.demand.get(key, 0) + masks.shape[0]
                store.demand[key] = demand
                if self._cross_should_compose(key, order, links, demand,
                                              masks.shape[0]):
                    rel = self._compose_cross(start_ref, end_ref, mode,
                                              order, links)
                    if rel is not None:
                        rel = _transpose(rel)       # probe-ready: see _cross_probe
                        self.counters["cross_composes"] += 1
                        signature = self._crossed_signature(key)
                        if store.put(key, rel, signature):
                            entry = (rel, signature)
                        else:
                            store.failed.add(key)
                    else:
                        store.failed.add(key)
            if entry is not None:
                relT, signature = entry
                self.counters["cross_probes"] += 1
                self.counters["links_crossed"] += len(signature)
                return self._cross_probe(relT, masks)
        answer, _, crossed = self._traverse(
            start_ref, end_ref, mode, order, links, _MaskOps(self),
            masks.to(torch.bool))
        self.counters["links_crossed"] += len(crossed)
        if answer is None:
            return self._empty(masks.shape[0], end_ref)
        return answer

    # -- executors -------------------------------------------------------------
    def _check_cross_supported(self, plan: QueryPlan) -> None:
        if plan.values:
            raise FederationError(
                "a values plan runs within one member: its target's values are "
                "recomputed from that member's index")
        if plan.kind == "co_contributory" and plan.via is None:
            raise FederationError(
                "cross-index co_contributory needs an explicit via= dataset "
                "(the per-probe default requires one index's reach map)"
            )

    # -- cross-member attr / how walks -----------------------------------------
    def _attr_cross_perm(self, link: Link, reverse: bool) -> List[int]:
        """Column alignment across a boundary link, BY COLUMN NAME.

        ``perm[j]`` is the near-side column behind far-side column ``j``
        (``-1`` = the attribute has no counterpart and drops at the
        boundary).  Near/far follow traversal direction: forward crosses
        up→down, backward down→up."""
        up_cols = list(self.catalog.datasets[link.up].columns)
        down_cols = list(self.catalog.datasets[link.down].columns)
        near, far = (down_cols, up_cols) if reverse else (up_cols, down_cols)
        pos = {c: i for i, c in enumerate(near)}
        return [pos.get(c, -1) for c in far]

    def _route_or_none(self, plan: QueryPlan, mode: str):
        """(order, links, out_links) for the plan's source→target route, or
        None when no link path exists (the empty answer)."""
        reverse = mode == "bwd"
        route = self._route(split_ref(plan.source)[0], split_ref(plan.target)[0],
                            reverse=reverse)
        if route is None:
            return None
        order, links = route
        return order, links, self._out_links(links, reverse)

    @staticmethod
    def _trace_link(hops: List[List[Hop]], crossed: torch.Tensor, near_ref: str,
                    far_ref: str) -> None:
        """A ``category="link"`` hop for every probe with rows across (one
        host read of the per-probe counts)."""
        for b, c in enumerate(crossed.sum(dim=1).tolist()):
            if c:
                hops[b].append(Hop(-1, "boundary", "link", near_ref, far_ref, int(c)))

    def _execute_record_how(self, plan: QueryPlan) -> List:
        """Cross-member record+how: per-member multi-seed record walks
        (ONE pass per member over all its boundary entries, so shared ops
        are traced once — exactly the merged walk's trace), stitched across
        links.  Each crossing adds a synthetic ``category="link"`` hop."""
        B = plan.n_probes
        mode = "fwd" if plan.direction == "fwd" else "bwd"
        reverse = mode == "bwd"
        hops: List[List[Hop]] = [[] for _ in range(B)]
        out = self._empty(B, plan.target)
        routed = self._route_or_none(plan, mode)
        if routed is None:
            empty = torch.zeros(0, dtype=torch.int64, device=self.device)
            return [(empty, hops[b]) for b in range(B)]
        order, _, out_links = routed
        m0, d0 = split_ref(plan.source)
        m1, d1 = split_ref(plan.target)
        entries: Dict[str, Dict[str, torch.Tensor]] = {
            m0: {d0: plan.rows.to(torch.bool)}}
        for m in order:
            ent = entries.pop(m, None)
            if not ent:
                continue
            member = self.catalog.members[m]
            self.counters["segments"] += len(ent)
            masks, mhops = member.run_record_terms(ent, mode, collect_hops=True)
            for b in range(B):
                hops[b].extend(mhops[b])
            if m == m1 and d1 in masks:
                out = out | masks[d1]
            for link in out_links.get(m, []):
                near_ref, far_ref = (
                    (link.down, link.up) if reverse else (link.up, link.down))
                far_m, far_ds = split_ref(far_ref)
                val = masks.get(split_ref(near_ref)[1])
                if val is None or not bool(val.any()):
                    continue
                self.counters["links_crossed"] += 1
                n_up, n_down = self._link_rows(link)
                stitched = (link.stitch_up(val, n_up) if reverse
                            else link.stitch_down(val, n_down))
                self._trace_link(hops, stitched, near_ref, far_ref)
                dest = entries.setdefault(far_m, {})
                prev = dest.get(far_ds)
                dest[far_ds] = stitched if prev is None else prev | stitched
        return list(zip(rows_per_probe(out), hops))

    def _execute_cells(self, plan: QueryPlan) -> List:
        """Cross-member cells / cells+how: per-member attr-TERM walks
        joined by link stitches.  Row masks cross through the link's row
        alignment; packed attribute words unpack, re-align by column name
        (:meth:`_attr_cross_perm`), and repack.  The final cell list
        (:func:`repro_torch.core.query._cells_batch`) is built once at the
        target."""
        B = plan.n_probes
        mode = "fwd" if plan.direction == "fwd" else "bwd"
        reverse = mode == "bwd"
        tgt = self.catalog.datasets[plan.target]
        hops: List[List[Hop]] = [[] for _ in range(B)]
        target_terms: List = []
        routed = self._route_or_none(plan, mode)
        if routed is not None:
            order, _, out_links = routed
            m0, d0 = split_ref(plan.source)
            m1, d1 = split_ref(plan.target)
            seed = (plan.rows.to(torch.bool),
                    pack_bitplane(plan.attrs.to(torch.bool).contiguous()))
            entries: Dict[str, Dict[str, List]] = {m0: {d0: [seed]}}
            for m in order:
                ent = entries.pop(m, None)
                if not ent:
                    continue
                member = self.catalog.members[m]
                self.counters["segments"] += len(ent)
                ent = {ds: ts for ds, ts in ent.items() if ts}
                if not ent:
                    # every term dropped at the boundary (its attributes have
                    # no counterpart, or its rows no alignment): nothing to walk
                    continue
                if plan.how:
                    terms, _, mhops = member.run_attr_terms(ent, mode, collect_hops=True)
                    for b in range(B):
                        hops[b].extend(mhops[b])
                else:
                    terms, _ = member.run_attr_terms(ent, mode)
                if m == m1:
                    target_terms = terms.get(d1, [])
                for link in out_links.get(m, []):
                    near_ref, far_ref = (
                        (link.down, link.up) if reverse else (link.up, link.down))
                    far_m, far_ds = split_ref(far_ref)
                    near_terms = terms.get(split_ref(near_ref)[1], [])
                    if not near_terms:
                        continue
                    self.counters["links_crossed"] += 1
                    n_up, n_down = self._link_rows(link)
                    n_far = n_up if reverse else n_down
                    n_near_cols = self.catalog.datasets[near_ref].n_cols
                    perm = self._attr_cross_perm(link, reverse)
                    far_cols = [j for j, p in enumerate(perm) if p >= 0]
                    near_cols = torch.as_tensor([perm[j] for j in far_cols],
                                                dtype=torch.int64, device=self.device)
                    far_idx = torch.as_tensor(far_cols, dtype=torch.int64, device=self.device)
                    dest = entries.setdefault(far_m, {}).setdefault(far_ds, [])
                    crossed = torch.zeros((B, n_far), dtype=torch.bool, device=self.device)
                    for rm, aw in near_terms:
                        new_rm = (link.stitch_up(rm, n_up) if reverse
                                  else link.stitch_down(rm, n_down))
                        am = unpack_bitplane(aw, n_near_cols)
                        new_am = torch.zeros((B, len(perm)), dtype=torch.bool,
                                             device=self.device)
                        new_am[:, far_idx] = am[:, near_cols]
                        live_rm, live_am = new_rm.any(dim=1), new_am.any(dim=1)
                        if bool(torch.stack([live_rm.any(), live_am.any()]).all()):
                            dest.append((new_rm, pack_bitplane(new_am)))
                            crossed |= new_rm & (live_rm & live_am)[:, None]
                    if plan.how:
                        self._trace_link(hops, crossed, near_ref, far_ref)
        cells = _cells_batch(target_terms, B, tgt.n_rows, tgt.n_cols, self.device)
        if plan.how:
            return list(zip(cells, hops))
        return cells

    def _execute(self, plan: QueryPlan) -> List:
        """One payload per probe for a CROSS-member plan."""
        self._check_cross_supported(plan)
        self.counters["federated"] += 1
        if plan.n_probes == 0:
            return []
        if plan.kind == "cells":
            return self._execute_cells(plan)
        if plan.kind == "record" and plan.how:
            return self._execute_record_how(plan)
        if plan.kind == "record":
            out = self._propagate(plan.source, plan.target, plan.rows,
                                  mode="fwd" if plan.direction == "fwd" else "bwd")
        elif plan.kind == "co_contributory":
            via_masks = self._propagate(plan.source, plan.via, plan.rows, mode="fwd")
            out = self._propagate(plan.via, plan.target, via_masks, mode="bwd")
        elif plan.kind == "co_dependency":
            anc = self._propagate(plan.source, plan.anchor, plan.rows, mode="bwd")
            out = self._propagate(plan.anchor, plan.target, anc, mode="fwd")
        else:
            raise FederationError(
                f"{plan.kind} plans take one dataset ref and never cross members")
        return rows_per_probe(out)

    # -- the QuerySession surface ----------------------------------------------
    def run(self, plan):
        """Execute one plan (a :class:`QueryPlan` over qualified refs, or a
        builder).  Single-member plans delegate wholesale to the owning
        member's session — every plan kind, identical shapes; cross-member
        plans split, stitch, and return the same shapes."""
        plan = plan if isinstance(plan, QueryPlan) else plan.plan()
        self.counters["plans"] += 1
        names = self._plan_members(plan)
        if len(names) == 1:
            self.counters["single_index"] += 1
            return self.catalog.members[names[0]].run(self._unqualified(plan))
        per = self._execute(plan)
        return per if plan.batched else per[0]

    def run_many(self, plans: Sequence) -> List:
        """Batch execution with fuse-key fusion (the ``QuerySession.run_many``
        contract): cross-member plans sharing a route pack into ONE
        propagation — one record pass per member segment for the group."""
        return run_many_fused(plans, self.run, self._run_fused, self.counters)

    def _run_fused(self, fused: QueryPlan) -> List:
        names = self._plan_members(fused)
        if len(names) == 1:
            self.counters["single_index"] += 1
            return self.catalog.members[names[0]].run(self._unqualified(fused))
        return self._execute(fused)

    def explain(self, plan) -> Dict[str, object]:
        """The route without executing: per-segment strategy/cost from each
        owning member's planner, the links crossed, and the top-level
        verdict — never just a stitched total."""
        plan = plan if isinstance(plan, QueryPlan) else plan.plan()
        names = self._plan_members(plan)
        out: Dict[str, object] = {"plan": plan.describe()}
        if len(names) == 1:
            out.update(self.catalog.members[names[0]].explain(self._unqualified(plan)))
            out["federated"] = False
            out["index"] = names[0]
            return out
        self._check_cross_supported(plan)
        out["federated"] = True
        out["strategy"] = "federated"
        legs: List[Tuple[str, str, str]] = []
        if plan.kind in ("record", "cells"):
            legs = [(plan.source, plan.target,
                     "fwd" if plan.direction == "fwd" else "bwd")]
        elif plan.kind == "co_contributory":
            legs = [(plan.source, plan.via, "fwd"), (plan.via, plan.target, "bwd")]
        elif plan.kind == "co_dependency":
            legs = [(plan.source, plan.anchor, "bwd"), (plan.anchor, plan.target, "fwd")]
        segments: List[Dict[str, object]] = []
        links: List[str] = []
        B = max(plan.n_probes, 1)
        for start, end, mode in legs:
            dry = self._propagate(start, end, None, mode=mode)
            if dry is None:
                segments.append({"leg": f"{start}->{end}", "route": None})
                continue
            segs, crossed = dry
            links.extend(f"{link.up} => {link.down}" for link in crossed)
            for seg in segs:
                if plan.kind == "cells" or plan.how:
                    # attr planes / hop traces live on the per-op walk:
                    # every member segment of such a plan walks
                    segments.append({
                        "index": seg.member,
                        "segment": f"{seg.source}->{seg.target}",
                        "direction": seg.direction,
                        "strategy": "walk",
                    })
                    continue
                member = self.catalog.members[seg.member]
                n = member.datasets[seg.source].n_rows
                probe = torch.zeros((B, n), dtype=torch.bool, device=self.device)
                if n:
                    probe[:, 0] = True      # nominal single-row probes
                sub = QueryPlan(kind="record", source=seg.source,
                                target=seg.target, direction=seg.direction,
                                rows=probe, batched=True)
                inner = member.explain(sub)
                segments.append({
                    "index": seg.member,
                    "segment": f"{seg.source}->{seg.target}",
                    "direction": seg.direction,
                    "strategy": inner.get("strategy"),
                    **({"cost": inner["cost"]} if "cost" in inner else {}),
                })
        out["segments"] = segments
        out["links"] = links
        return out

    def stats(self) -> Dict:
        """Federation counters plus EVERY member's full session stats,
        keyed by registered index name — per-index planner and hop-cache
        counters stay attributable after federation."""
        return {
            "federation": dict(self.counters),
            "indexes": {name: member.stats()
                        for name, member in self.catalog.members.items()},
        }
