"""Serving: the batched generation engine and the async query tier.

* :class:`~repro_torch.serve.engine.ServeEngine` — decode-step generation
  with request-level provenance capture (one engine, one model);
* :class:`~repro_torch.serve.tier.ServingTier` — the async micro-batching
  front door that fuses lineage queries across requests and tenants into
  single ``run_many`` passes, with bounded admission and per-tenant
  capability scoping (:mod:`repro_torch.serve.admission`).
"""
from repro_torch.serve.admission import (
    AdmissionError,
    QueueFullError,
    TenantOverloadError,
    TenantScope,
    TierClosedError,
)
from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.tier import ServingTier

__all__ = [
    "ServeEngine",
    "GenerationResult",
    "ServingTier",
    "TenantScope",
    "AdmissionError",
    "QueueFullError",
    "TenantOverloadError",
    "TierClosedError",
]
