"""repro_torch.provenance — the lazy query-plan API over one index.

* :func:`prov` — fluent lazy builder,
  ``prov(index).source("D_l").rows([...]).forward().to(sink).run()``;
* :class:`QueryPlan` — the explicit IR a builder compiles to;
* :class:`QuerySession` — planner/executor; routes linear record chains to
  the fused K-hop kernel and fuses ``run_many`` batches that share
  endpoints into one pass.

Federation, impact analysis and sharding are later slices (ROADMAP A8-A10).
"""
from repro_torch.provenance.builder import ProvQuery, prov
from repro_torch.provenance.plan import QueryPlan
from repro_torch.provenance.session import QuerySession

__all__ = [
    "prov",
    "ProvQuery",
    "QueryPlan",
    "QuerySession",
]
