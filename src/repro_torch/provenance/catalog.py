"""The federated provenance catalog: named indexes, links, capabilities.

One :class:`~repro_torch.core.pipeline.ProvenanceIndex` holds ONE
pipeline's provenance, but a deployment spans several — the data-prep
pipeline's index and the serving engine's index at minimum.  This module is
the glue that lets one query cross those ownership boundaries WITHOUT
merging the indexes or handing any party the other's mutable index object:

* :class:`ProvCatalog` — a registry of named members (full indexes or
  capability handles) plus :meth:`~ProvCatalog.link` declarations tying an
  output dataset of one member to a source dataset of another (optionally
  through a row **alignment**).  Dataset refs are *index-qualified* strings
  ``"name/dataset"``; ``prov(catalog)`` builds federated plans over them and
  :meth:`ProvCatalog.session` executes them
  (:class:`~repro_torch.provenance.federation.FederatedSession`).  Every
  member, and every alignment, lies on the catalog's device.
* :class:`BoundaryHandle` — a READ-ONLY capability minted by
  :meth:`ProvenanceIndex.export(dataset_id)
  <repro_torch.core.pipeline.ProvenanceIndex.export>`.  It grants probe
  access to relations among the *ancestors* of the exported boundary
  dataset and nothing else: no ``record()`` / ``add_source()`` (they raise
  :class:`CapabilityError`), no resolution of non-ancestor datasets.  The
  ancestor set is fixed at export time — the op DAG is append-only with one
  producer per dataset, so no later write can grow a dataset's ancestry.
* typed errors — :class:`CapabilityError` for capability violations,
  :class:`FederationError` for malformed refs / links / unroutable plans.

Row alignment across a link: ``alignment[j]`` is the row of the *upstream*
boundary dataset that row ``j`` of the *downstream* source dataset came
from (``-1`` marks a downstream row with no upstream origin, e.g. an
injected request).  ``None`` means identity (row counts must match).
Forward mask stitching gathers ``down[:, j] = up[:, alignment[j]]``;
backward stitching OR-scatters (duplicate upstream rows accumulate).  Both
run on the device without reading the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compose import binary_csr, csr_from_pairs
from repro_torch.core.device import resolve_device

__all__ = [
    "ProvCatalog",
    "BoundaryHandle",
    "Link",
    "CapabilityError",
    "FederationError",
    "split_ref",
    "qualify",
]

QUALIFIER = "/"


class CapabilityError(PermissionError):
    """An operation the held capability does not grant (mutation through a
    :class:`BoundaryHandle`, or resolving a dataset outside its ancestor
    closure)."""


class FederationError(ValueError):
    """A malformed qualified ref / link declaration, a member on another
    device, or a plan the federation cannot route."""


def split_ref(ref: str) -> Tuple[str, str]:
    """``"name/dataset"`` -> ``(name, dataset)``.  Splits on the FIRST
    qualifier so dataset ids may themselves contain ``/`` suffix parts."""
    if not isinstance(ref, str) or QUALIFIER not in ref:
        raise FederationError(
            f"expected an index-qualified dataset ref 'index/dataset', got "
            f"{ref!r}"
        )
    name, ds = ref.split(QUALIFIER, 1)
    if not name or not ds:
        raise FederationError(f"malformed qualified ref {ref!r}")
    return name, ds


def qualify(name: str, dataset_id: str) -> str:
    return f"{name}{QUALIFIER}{dataset_id}"


# ---------------------------------------------------------------------------
# Capability handle
# ---------------------------------------------------------------------------
class _AncestorView(Mapping):
    """Read-only view of an index's datasets restricted to an ancestor
    closure.  Membership tests outside the closure answer False (the
    capability does not even reveal existence); *resolving* a dataset that
    exists but lies outside the closure raises :class:`CapabilityError` so
    misuse is loud, not silently empty."""

    def __init__(self, index, allowed: frozenset) -> None:
        self._index = index
        self._allowed = allowed

    def __getitem__(self, dataset_id: str):
        if dataset_id in self._allowed:
            return self._index.datasets[dataset_id]
        if dataset_id in self._index.datasets:
            raise CapabilityError(
                f"dataset {dataset_id!r} is not an ancestor of the exported "
                "boundary; this BoundaryHandle cannot resolve it"
            )
        raise KeyError(dataset_id)

    def __contains__(self, dataset_id) -> bool:
        return dataset_id in self._allowed

    def __iter__(self) -> Iterator[str]:
        # index insertion order restricted to the closure (deterministic)
        return (d for d in self._index.datasets if d in self._allowed)

    def __len__(self) -> int:
        return len(self._allowed)


def _filter_hops(hops, allowed: frozenset):
    return [[h for h in trace
             if h.src_dataset in allowed and h.dst_dataset in allowed]
            for trace in hops]


class BoundaryHandle:
    """A read-only probe capability over the ancestors of one exported
    dataset.  Minted by ``ProvenanceIndex.export(dataset_id)``; the exporting
    index keeps its ``ComposedIndex`` / ``QuerySession`` private and merely
    answers plans the handle has validated.

    The handle deliberately does NOT subclass or proxy ``ProvenanceIndex``:
    the only verbs it exposes are reads, and ``record`` / ``add_source``
    exist solely to raise :class:`CapabilityError`.
    """

    is_handle = True

    def __init__(self, index, boundary: str) -> None:
        if boundary not in index.datasets:
            raise KeyError(f"unknown dataset {boundary!r}")
        self.boundary = boundary
        self.index_name = index.name
        self.device = index.device
        allowed = {boundary}
        for op in index.upstream_ops(boundary):
            allowed.add(op.output_id)
            allowed.update(op.input_ids)
        self._ancestors = frozenset(allowed)
        # name-mangled: the index object is the handle's private business
        self.__index = index

    # -- capability surface (reads) -----------------------------------------
    @property
    def datasets(self) -> Mapping:
        return _AncestorView(self.__index, self._ancestors)

    def path_exists(self, src: str, dst: str) -> bool:
        self._check_ref(src)
        self._check_ref(dst)
        return self.__index.path_exists(src, dst)

    def is_source_dataset(self, dataset_id: str) -> bool:
        """Whether ``dataset_id`` has no producer op (link-target check)."""
        self._check_ref(dataset_id)
        return dataset_id not in self.__index.producer

    def run(self, plan):
        self._check_plan(plan)
        return self.__index.session().run(plan)

    def run_many(self, plans) -> List:
        plans = list(plans)
        for p in plans:
            self._check_plan(p)
        return self.__index.session().run_many(plans)

    def run_masks(self, plan) -> torch.Tensor:
        self._check_plan(plan)
        return self.__index.session().run_masks(plan)

    def run_record_terms(self, entry_masks, direction, collect_hops=False):
        """Multi-seed record propagation among the granted ancestors.

        Entries must be ancestors, and the returned masks (and hop traces)
        are FILTERED to the ancestor closure — a walk that escapes the
        capability's footprint reveals nothing about the rest of the index.
        """
        for ds in entry_masks:
            self._check_ref(ds)
        out = self.__index.session().run_record_terms(
            entry_masks, direction, collect_hops=collect_hops)
        masks, hops = out if collect_hops else (out, None)
        masks = {d: m for d, m in masks.items() if d in self._ancestors}
        if not collect_hops:
            return masks
        return masks, _filter_hops(hops, self._ancestors)

    def run_attr_terms(self, entry_terms, direction, collect_hops=False):
        """Multi-seed attr-term propagation among the granted ancestors
        (same filtering contract as :meth:`run_record_terms`)."""
        for ds in entry_terms:
            self._check_ref(ds)
        out = self.__index.session().run_attr_terms(
            entry_terms, direction, collect_hops=collect_hops)
        terms, B = out[0], out[1]
        terms = {d: t for d, t in terms.items() if d in self._ancestors}
        if not collect_hops:
            return terms, B
        return terms, B, _filter_hops(out[2], self._ancestors)

    def relation_csr(self, src: str, dst: str) -> torch.Tensor:
        """The composed ``src``→``dst`` relation (torch sparse CSR) — the
        probe capability the export grants, in relation form; ancestors
        only."""
        self._check_ref(src)
        self._check_ref(dst)
        return self.__index.composed().relation_csr(src, dst)

    def relation_stats(self, src: str, dst: str):
        """``(RelStats | None, estimated one-time compose ns)`` for the
        composed ``src``→``dst`` relation — statistics only, no composition
        work (:meth:`repro_torch.core.costmodel.CostModel.composed_estimate`).
        The cost-model read behind the federation's stitched-relation gate;
        ancestors only, like every other granted read."""
        self._check_ref(src)
        self._check_ref(dst)
        return self.__index.session().costmodel.composed_estimate(src, dst)

    def explain(self, plan) -> Dict[str, object]:
        self._check_plan(plan)
        return self.__index.session().explain(plan)

    def stats(self) -> Dict:
        return self.__index.session().stats()

    # -- denied verbs --------------------------------------------------------
    def record(self, *args, **kwargs):
        raise CapabilityError(
            "BoundaryHandle is read-only: record() is not granted "
            "(only the exporting index may register operations)"
        )

    def add_source(self, *args, **kwargs):
        raise CapabilityError(
            "BoundaryHandle is read-only: add_source() is not granted"
        )

    def export(self, dataset_id: str) -> "BoundaryHandle":
        """Attenuate: re-export any ancestor as a narrower handle."""
        self._check_ref(dataset_id)
        return BoundaryHandle(self.__index, dataset_id)

    # -- validation ----------------------------------------------------------
    def _check_ref(self, dataset_id: str) -> None:
        if dataset_id not in self._ancestors:
            raise CapabilityError(
                f"dataset {dataset_id!r} is not an ancestor of boundary "
                f"{self.boundary!r}; this BoundaryHandle cannot touch it"
            )

    def _check_plan(self, plan) -> None:
        for ref in plan.refs():
            self._check_ref(ref)

    def __repr__(self) -> str:
        return (f"BoundaryHandle({self.index_name}/{self.boundary}, "
                f"{len(self._ancestors)} ancestor datasets)")


class _IndexMember:
    """Full-access member adapter: the same surface as
    :class:`BoundaryHandle`, over an owned :class:`ProvenanceIndex`."""

    is_handle = False

    def __init__(self, index) -> None:
        self._index = index
        self.index_name = index.name
        self.device = index.device

    @property
    def datasets(self):
        return self._index.datasets

    def path_exists(self, src: str, dst: str) -> bool:
        return self._index.path_exists(src, dst)

    def is_source_dataset(self, dataset_id: str) -> bool:
        return dataset_id not in self._index.producer

    def run(self, plan):
        return self._index.session().run(plan)

    def run_many(self, plans) -> List:
        return self._index.session().run_many(plans)

    def run_masks(self, plan) -> torch.Tensor:
        return self._index.session().run_masks(plan)

    def run_record_terms(self, entry_masks, direction, collect_hops=False):
        return self._index.session().run_record_terms(
            entry_masks, direction, collect_hops=collect_hops)

    def run_attr_terms(self, entry_terms, direction, collect_hops=False):
        return self._index.session().run_attr_terms(
            entry_terms, direction, collect_hops=collect_hops)

    def relation_csr(self, src: str, dst: str) -> torch.Tensor:
        return self._index.composed().relation_csr(src, dst)

    def relation_stats(self, src: str, dst: str):
        return self._index.session().costmodel.composed_estimate(src, dst)

    def explain(self, plan) -> Dict[str, object]:
        return self._index.session().explain(plan)

    def stats(self) -> Dict:
        return self._index.session().stats()


# ---------------------------------------------------------------------------
# Links
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Link:
    """One declared boundary: rows of ``down`` (a source dataset of the
    downstream member) are rows of ``up`` (any dataset of the upstream
    member), related by ``alignment`` (None = identity): an int64 tensor of
    ``(n_down,)`` up rows on the catalog's device, ``-1`` = none."""

    up: str                                 # qualified "prep/clean"
    down: str                               # qualified "serve/requests@0"
    alignment: Optional[torch.Tensor]       # (n_down,) int64; -1 = none
    device: Optional[torch.device] = None   # None: the alignment's (CPU for identity)
    # linked down rows, a host int counted once at declaration (the cost
    # gate prices links from it without reading the device per probe)
    n_linked: Optional[int] = dataclasses.field(init=False, default=None)

    def __post_init__(self) -> None:
        if self.alignment is not None:
            object.__setattr__(self, "device", self.alignment.device)
            object.__setattr__(self, "n_linked", int((self.alignment >= 0).sum()))
        elif self.device is None:
            object.__setattr__(self, "device", torch.device("cpu"))

    def _gather(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(valid (n_down,) bool, up row per down row with -1 -> 0)."""
        valid = self.alignment >= 0
        return valid, torch.where(valid, self.alignment, torch.zeros_like(self.alignment))

    def stitch_down(self, up_masks: torch.Tensor, n_down: int) -> torch.Tensor:
        """(B, n_up) upstream masks -> (B, n_down) downstream masks: one
        gather along the alignment."""
        if self.alignment is None:
            return up_masks
        valid, safe = self._gather()
        return up_masks[:, safe] & valid[None, :]

    def stitch_up(self, down_masks: torch.Tensor, n_up: int) -> torch.Tensor:
        """(B, n_down) downstream masks -> (B, n_up) upstream masks.
        Duplicate alignments OR-accumulate (two requests over one upstream
        row both light it up): an integer scatter-add, exact in any order,
        with unlinked rows sent to a spare column that is cut off."""
        if self.alignment is None:
            return down_masks
        valid = self.alignment >= 0
        idx = torch.where(valid, self.alignment, torch.full_like(self.alignment, n_up))
        out = torch.zeros((down_masks.shape[0], n_up + 1), dtype=torch.int32,
                          device=down_masks.device)
        out.index_add_(1, idx, down_masks.to(torch.int32))
        return out[:, :n_up] > 0

    def matrix(self, n_up: int, n_down: int) -> torch.Tensor:
        """The alignment as an ``(n_up, n_down)`` torch sparse CSR selection
        (int32 indices, float32 ones): ``A[alignment[j], j] = 1`` — so
        ``R_up @ A`` stitches a start→up relation down, and ``R_down @ A.T``
        stitches back up (the relation-level twins of :meth:`stitch_down` /
        :meth:`stitch_up`, used by the federation's cross-index relation
        compose)."""
        if self.alignment is None:
            i = torch.arange(n_up + 1, dtype=torch.int32, device=self.device)
            return binary_csr(i, i[:-1], n_up, n_up)
        sel = torch.nonzero(self.alignment >= 0).reshape(-1)
        return csr_from_pairs(self.alignment[sel], sel, n_up, n_down)


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------
class _CatalogDatasets:
    """Qualified-ref resolution with the mapping protocol the fluent
    builder already speaks — ``prov(catalog).source("prep/raw")`` needs
    only ``in`` and ``[]``."""

    def __init__(self, catalog: "ProvCatalog") -> None:
        self._catalog = catalog

    def __contains__(self, ref) -> bool:
        try:
            member, ds = self._catalog.resolve(ref)
        except (FederationError, KeyError):
            return False
        return ds in member.datasets

    def __getitem__(self, ref: str):
        member, ds = self._catalog.resolve(ref)
        return member.datasets[ds]

    def __iter__(self) -> Iterator[str]:
        for name, member in self._catalog.members.items():
            for ds in member.datasets:
                yield qualify(name, ds)


class ProvCatalog:
    """Named provenance members + boundary links: the federation's schema.

    ::

        catalog = ProvCatalog()                        # device=None: the card
        catalog.register("prep", prep_index)           # full access
        catalog.register("serve", serve_index)
        catalog.link("prep/clean", "serve/requests@0",
                     alignment=request_rows)           # rows into prep/clean

        prov(catalog).source("serve/responses@0").rows([2]) \\
            .backward().to("prep/raw").run()

    Members are either full :class:`ProvenanceIndex` objects or read-only
    :class:`BoundaryHandle` capabilities, all on the catalog's ``device``
    (``None`` means the CUDA card and raises without one); queries route
    through each member's own shared ``QuerySession`` (cost-model planning,
    private hop-cache), so federation never merges or copies provenance.
    """

    def __init__(self, name: str = "catalog", device=None) -> None:
        self.name = name
        self.device = resolve_device(device)
        self.members: Dict[str, object] = {}      # name -> member adapter
        self.links: List[Link] = []
        self._session = None

    # -- registration ---------------------------------------------------------
    def register(self, name: str, owner) -> "ProvCatalog":
        """Register ``owner`` (a ``ProvenanceIndex`` or a
        :class:`BoundaryHandle`) under ``name``."""
        if QUALIFIER in name or not name:
            raise FederationError(
                f"member name {name!r} must be non-empty and contain no "
                f"{QUALIFIER!r}"
            )
        if name in self.members:
            raise FederationError(f"member {name!r} already registered")
        if isinstance(owner, BoundaryHandle):
            member = owner
        elif hasattr(owner, "record") and hasattr(owner, "datasets"):
            member = _IndexMember(owner)
        else:
            raise TypeError(
                f"cannot register {type(owner).__name__}: expected a "
                "ProvenanceIndex or a BoundaryHandle"
            )
        if member.device != self.device:
            raise FederationError(
                f"member {name!r} lies on {member.device}, the catalog on "
                f"{self.device}"
            )
        self.members[name] = member
        return self

    def member_of(self, index_or_handle) -> Optional[str]:
        """The registered name of ``index_or_handle``, if any."""
        for name, m in self.members.items():
            if m is index_or_handle or getattr(m, "_index", None) is index_or_handle:
                return name
        return None

    def resolve(self, ref: str):
        """``"name/dataset"`` -> ``(member, dataset_id)``."""
        name, ds = split_ref(ref)
        if name not in self.members:
            raise FederationError(
                f"unknown index {name!r} in ref {ref!r} "
                f"(registered: {sorted(self.members)})"
            )
        return self.members[name], ds

    @property
    def datasets(self) -> _CatalogDatasets:
        return _CatalogDatasets(self)

    # -- links ----------------------------------------------------------------
    def link(self, up_ref: str, down_ref: str, alignment=None) -> Link:
        """Declare that ``down_ref`` (a SOURCE dataset of its member — no
        producer op) holds rows drawn from ``up_ref`` in another member.
        ``alignment[j]`` is the ``up`` row behind ``down`` row ``j``
        (``-1`` = none; a sequence, numpy array or a tensor on the
        catalog's device); ``None`` means identity and requires equal row
        counts."""
        up_name, up_ds = split_ref(up_ref)
        down_name, down_ds = split_ref(down_ref)
        if up_name == down_name:
            raise FederationError(
                f"link endpoints must live in different members, both are "
                f"{up_name!r} (intra-index lineage is already an op)"
            )
        up_member, _ = self.resolve(up_ref)
        down_member, _ = self.resolve(down_ref)
        up_rec = up_member.datasets[up_ds]          # raises if not resolvable
        down_rec = down_member.datasets[down_ds]
        if not down_member.is_source_dataset(down_ds):
            raise FederationError(
                f"link target {down_ref!r} has a producer op in its own "
                "index; only source datasets can receive boundary rows"
            )
        if alignment is not None:
            if isinstance(alignment, torch.Tensor):
                if alignment.device != self.device:
                    raise FederationError(
                        f"alignment lies on {alignment.device}, the catalog "
                        f"on {self.device}")
                alignment = alignment.to(torch.int64).clone()
            else:
                alignment = torch.as_tensor(np.asarray(alignment, dtype=np.int64),
                                            device=self.device)
            if tuple(alignment.shape) != (down_rec.n_rows,):
                raise FederationError(
                    f"alignment has shape {tuple(alignment.shape)}, link "
                    f"target {down_ref!r} has {down_rec.n_rows} rows"
                )
            if alignment.numel():
                lo, hi = torch.aminmax(alignment)
                if int(hi) >= up_rec.n_rows or int(lo) < -1:
                    raise FederationError(
                        f"alignment rows must be in [-1, {up_rec.n_rows}) for "
                        f"{up_ref!r}"
                    )
        elif up_rec.n_rows != down_rec.n_rows:
            raise FederationError(
                f"identity link needs equal row counts: {up_ref!r} has "
                f"{up_rec.n_rows}, {down_ref!r} has {down_rec.n_rows} "
                "(pass alignment=...)"
            )
        link = Link(up=up_ref, down=down_ref, alignment=alignment, device=self.device)
        self.links.append(link)
        return link

    # -- execution ------------------------------------------------------------
    def session(self, **kwargs):
        """The catalog's shared
        :class:`~repro_torch.provenance.federation.FederatedSession` — same
        ``run`` / ``run_many`` / ``explain`` / ``stats`` surface as
        ``QuerySession``, plan-splitting across members."""
        from repro_torch.provenance.federation import FederatedSession  # circular at module scope

        if self._session is None:
            self._session = FederatedSession(self, **kwargs)
        elif kwargs:
            raise ValueError("session() already configured; use catalog.session()")
        return self._session

    def stats(self) -> Dict:
        return self.session().stats()

    def __repr__(self) -> str:
        return (f"ProvCatalog({self.name!r}, members={sorted(self.members)}, "
                f"links={len(self.links)})")
