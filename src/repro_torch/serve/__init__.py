"""Serving: the async query tier of the port.

:class:`~repro_torch.serve.tier.ServingTier` is the micro-batching front
door that fuses lineage queries across requests and tenants into single
``run_many`` passes, with bounded admission and per-tenant capability
scoping (:mod:`repro_torch.serve.admission`).  The generation engine of
``repro.serve`` (``ServeEngine``) is not ported yet (ROADMAP A13).
"""
from repro_torch.serve.admission import (
    AdmissionError,
    QueueFullError,
    TenantOverloadError,
    TenantScope,
    TierClosedError,
)
from repro_torch.serve.tier import ServingTier

__all__ = [
    "ServingTier",
    "TenantScope",
    "AdmissionError",
    "QueueFullError",
    "TenantOverloadError",
    "TierClosedError",
]
