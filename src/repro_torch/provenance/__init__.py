"""repro_torch.provenance — the lazy query-plan API, federation and impact.

* :func:`prov` — fluent lazy builder,
  ``prov(index).source("D_l").rows([...]).forward().to(sink).run()``, or over
  a :class:`ProvCatalog` with index-qualified refs
  (``prov(catalog).source("prep/raw")...``);
* :class:`QueryPlan` — the explicit IR a builder compiles to;
* :class:`QuerySession` — planner/executor over one index; routes linear
  record chains to the fused K-hop kernel and fuses ``run_many`` batches
  that share endpoints into one pass;
* :class:`ProvCatalog` / :class:`BoundaryHandle` / :class:`FederatedSession`
  — several indexes joined by boundary links, read-only export
  capabilities, and the session that splits plans across members and
  stitches mask stacks (or a cached stitched relation) across links;
* :func:`erasure_plan` / :func:`apply_invalidations` / :func:`whatif_replay`
  — impact analysis: the downstream closure of erased rows with the caches
  it poisons, and a replay of only the provenance-related sink rows under a
  source perturbation.

* :class:`ShardedProvenanceIndex` / :class:`ShardedComposedIndex` /
  :class:`ShardedTensor` — a row-range-sharded view over one index (the
  sequential per-shard engine), its per-shard hop-cache, and its seam into
  a catalog of shard members.
"""
from repro_torch.provenance.builder import ProvQuery, prov
from repro_torch.provenance.catalog import (
    BoundaryHandle,
    CapabilityError,
    FederationError,
    Link,
    ProvCatalog,
)
from repro_torch.provenance.federation import FederatedSession
from repro_torch.provenance.impact import (
    CacheInvalidation,
    DatasetImpact,
    RecomputePlan,
    WhatIfResult,
    apply_invalidations,
    erasure_plan,
    whatif_replay,
)
from repro_torch.provenance.plan import QueryPlan
from repro_torch.provenance.session import ProbeValues, QuerySession, RecordValues
from repro_torch.provenance.sharded import (
    ShardedComposedIndex,
    ShardedProvenanceIndex,
    ShardedTensor,
)

__all__ = [
    "prov",
    "ProvQuery",
    "QueryPlan",
    "QuerySession",
    "RecordValues",
    "ProbeValues",
    "ProvCatalog",
    "BoundaryHandle",
    "FederatedSession",
    "Link",
    "CapabilityError",
    "FederationError",
    "RecomputePlan",
    "DatasetImpact",
    "CacheInvalidation",
    "WhatIfResult",
    "erasure_plan",
    "apply_invalidations",
    "whatif_replay",
    "ShardedTensor",
    "ShardedProvenanceIndex",
    "ShardedComposedIndex",
]
