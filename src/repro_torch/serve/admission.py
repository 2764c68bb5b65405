"""Admission control for the async serving tier.

The tier sits in front of shared query machinery (one ``QuerySession`` /
``FederatedSession`` per backend), so the failure mode of an unbounded
front door is global: one chatty tenant fills the accumulation buckets and
every other tenant's p99 explodes.  This module is the bounded front door:

* a **global queue bound** (``max_queue`` requests admitted-but-uncompleted)
  — submission past it either fails fast with :class:`QueueFullError`
  (typed rejection, the load-shedding default) or, with ``wait=True`` at
  the tier surface, blocks until capacity frees (backpressure);
* **per-tenant in-flight caps** (``max_inflight``) — a tenant that already
  holds its cap's worth of admitted requests gets
  :class:`TenantOverloadError` regardless of global headroom, so no tenant
  can monopolize the queue;
* **capability scoping** — each tenant holds a :class:`TenantScope`
  (typically derived from a :class:`~repro_torch.provenance.catalog.\
BoundaryHandle`, never the index itself); a submitted plan whose refs
  leave the scope raises the same typed
  :class:`~repro_torch.provenance.catalog.CapabilityError` the federation layer
  uses, *at admission time*, before the plan ever reaches a bucket;
* a **closed latch** — after shutdown begins every submission is rejected
  with :class:`TierClosedError` so drain can complete deterministically.

Everything here is plain single-threaded bookkeeping: the tier calls it
only from its event loop, so there are no locks to reason about.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, Optional

from repro_torch.provenance.catalog import CapabilityError

__all__ = [
    "AdmissionError",
    "QueueFullError",
    "TenantOverloadError",
    "TierClosedError",
    "TenantScope",
    "TenantState",
    "AdmissionController",
]


class AdmissionError(RuntimeError):
    """Base of every typed admission rejection (never raised directly)."""


class QueueFullError(AdmissionError):
    """The tier's global admission queue is at ``max_queue``; the request
    was shed.  Retry later or submit with ``wait=True`` for backpressure."""


class TenantOverloadError(AdmissionError):
    """This tenant already holds ``max_inflight`` admitted requests; the
    request was shed without touching global capacity."""


class TierClosedError(AdmissionError):
    """The tier is shutting down (or was never started); no new requests
    are admitted."""


# ---------------------------------------------------------------------------
# Capability scoping
# ---------------------------------------------------------------------------
class TenantScope:
    """The set of dataset refs one tenant's plans may touch.

    ``allowed=None`` means unrestricted (the operator tenant).  Build from
    a :class:`~repro_torch.provenance.catalog.BoundaryHandle` with
    :meth:`from_handle` — the scope copies the handle's ancestor-closure
    ref set at registration time and holds NO reference to the handle or
    its index afterwards, so a tier tenant can never reach provenance the
    export did not grant.
    """

    def __init__(self, allowed: Optional[Iterable[str]] = None) -> None:
        self.allowed: Optional[FrozenSet[str]] = (
            None if allowed is None else frozenset(allowed))

    @classmethod
    def from_handle(cls, handle, member: Optional[str] = None) -> "TenantScope":
        """Scope = the handle's ancestor closure.  ``member`` prefixes every
        dataset with the catalog name the handle is registered under, so the
        scope matches the qualified refs a federated backend's plans carry
        (bare refs are also kept, covering single-index backends)."""
        refs = set(handle.datasets)
        if member:
            refs |= {f"{member}/{ds}" for ds in set(refs)}
        return cls(refs)

    def check(self, plan) -> None:
        """Raise :class:`CapabilityError` when any ref of ``plan`` leaves
        the scope.  Mirrors ``BoundaryHandle._check_plan`` but over the
        tier's (possibly qualified) ref strings."""
        if self.allowed is None:
            return
        for ref in plan.refs():
            if ref not in self.allowed:
                raise CapabilityError(
                    f"ref {ref!r} is outside this tenant's capability scope "
                    f"({len(self.allowed)} granted refs); the serving tier "
                    "rejected the plan at admission"
                )

    def __repr__(self) -> str:
        n = "unrestricted" if self.allowed is None else f"{len(self.allowed)} refs"
        return f"TenantScope({n})"


@dataclasses.dataclass
class TenantState:
    """Per-tenant admission bookkeeping (all mutated on the tier's loop)."""

    name: str
    scope: TenantScope
    max_inflight: Optional[int]     # None = only the global bound applies
    inflight: int = 0
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    denied: int = 0                 # capability denials (CapabilityError)

    def snapshot(self) -> Dict[str, object]:
        return {
            "inflight": self.inflight,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "denied": self.denied,
            "scope": repr(self.scope),
        }


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------
class AdmissionController:
    """Bounded admission over the tier's request stream.

    ``admit`` runs the full gate (closed latch → capability → global bound
    → tenant cap) and on success charges both counters; every admitted
    request MUST eventually be returned through ``release`` exactly once
    (the tier does this when the request's future settles, success or
    failure).
    """

    def __init__(self, max_queue: int,
                 max_inflight_per_tenant: Optional[int] = None,
                 allow_unregistered: bool = True) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self.default_max_inflight = max_inflight_per_tenant
        self.allow_unregistered = allow_unregistered
        self.pending = 0            # admitted, not yet released
        self.closed = False
        self.tenants: Dict[str, TenantState] = {}
        self.counters: Dict[str, int] = {
            "admitted": 0,
            "rejected_queue_full": 0,
            "rejected_tenant_cap": 0,
            "rejected_closed": 0,
            "capability_denied": 0,
        }

    # -- registration --------------------------------------------------------
    def register(self, name: str, scope=None,
                 max_inflight: Optional[int] = None) -> TenantState:
        """Register (or re-scope) a tenant.  ``scope`` is a
        :class:`TenantScope`, a ``BoundaryHandle`` (converted — the handle
        itself is not retained), an iterable of allowed refs, or ``None``
        for unrestricted."""
        if isinstance(scope, TenantScope):
            ts = scope
        elif scope is None:
            ts = TenantScope(None)
        elif hasattr(scope, "datasets") and getattr(scope, "is_handle", False):
            ts = TenantScope.from_handle(scope)
        else:
            ts = TenantScope(scope)
        cap = max_inflight if max_inflight is not None \
            else self.default_max_inflight
        state = self.tenants.get(name)
        if state is None:
            state = TenantState(name, ts, cap)
            self.tenants[name] = state
        else:
            state.scope, state.max_inflight = ts, cap
        return state

    def _resolve(self, tenant: str) -> TenantState:
        state = self.tenants.get(tenant)
        if state is None:
            if not self.allow_unregistered:
                raise CapabilityError(
                    f"unknown tenant {tenant!r}: this tier only serves "
                    "registered tenants"
                )
            state = self.register(tenant)
        return state

    # -- the gate ------------------------------------------------------------
    def has_capacity(self, tenant: str) -> bool:
        """Whether ``admit`` would succeed right now on capacity grounds
        (the backpressure wait predicate; capability is not consulted)."""
        if self.closed or self.pending >= self.max_queue:
            return False
        state = self.tenants.get(tenant)
        return (state is None or state.max_inflight is None
                or state.inflight < state.max_inflight)

    def admit(self, tenant: str, plan) -> TenantState:
        if self.closed:
            self.counters["rejected_closed"] += 1
            raise TierClosedError(
                "the serving tier is shut down; no new requests are admitted")
        state = self._resolve(tenant)
        try:
            state.scope.check(plan)
        except CapabilityError:
            state.denied += 1
            self.counters["capability_denied"] += 1
            raise
        if self.pending >= self.max_queue:
            state.rejected += 1
            self.counters["rejected_queue_full"] += 1
            raise QueueFullError(
                f"admission queue full ({self.pending}/{self.max_queue} "
                "in flight); retry later or submit with wait=True")
        if state.max_inflight is not None and state.inflight >= state.max_inflight:
            state.rejected += 1
            self.counters["rejected_tenant_cap"] += 1
            raise TenantOverloadError(
                f"tenant {tenant!r} at its in-flight cap "
                f"({state.inflight}/{state.max_inflight})")
        self.pending += 1
        state.inflight += 1
        state.submitted += 1
        self.counters["admitted"] += 1
        return state

    def release(self, tenant: str) -> None:
        """One admitted request settled (result OR failure)."""
        self.pending -= 1
        state = self.tenants.get(tenant)
        if state is not None:
            state.inflight -= 1
            state.completed += 1

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "pending": self.pending,
            "max_queue": self.max_queue,
            "closed": self.closed,
            **{k: v for k, v in self.counters.items()},
            "tenants": {n: s.snapshot() for n, s in self.tenants.items()},
        }
