"""The async micro-batching serving tier: cross-request plan fusion.

``QuerySession.run_many`` fuses plans that share a fuse key into one packed
physical pass — but a session answers one caller at a time, synchronously,
in the caller's thread.  This module is the serving loop that turns the fuse-key
machinery into throughput:

* requests from many logical **tenants** enter through a bounded admission
  gate (:mod:`repro_torch.serve.admission` — typed rejection, per-tenant caps,
  capability scoping via ``BoundaryHandle``-derived :class:`TenantScope`);
* admitted plans accumulate in per-fuse-key **buckets**; a bucket flushes
  when it reaches ``max_batch`` plans or its oldest entry has waited
  ``max_wait_ms`` — the classic micro-batching latency/throughput dial;
* each flushed bucket executes as ONE ``backend.run_many`` call on a
  single executor thread (sessions are not thread-safe; serializing the
  executor is what makes the shared ``QuerySession`` / ``FederatedSession``
  safe to put behind a concurrent front door), and the fused results fan
  back out to each request's future;
* ``shutdown(drain=True)`` closes admission, flushes every bucket, and
  waits for the executor to go idle; ``drain=False`` rejects everything
  still queued with :class:`~repro_torch.serve.admission.TierClosedError`.

The tier is backend-agnostic: anything with ``run_many(plans)`` serves —
a ``QuerySession`` (single index, or the sharded view's session), a
``FederatedSession`` (catalog) or a ``BoundaryHandle`` (pre-scoped).  A
backend may expose ``prepare(plan)`` to normalize plans before admission
(ref qualification happens there so capability scoping and bucketing see
canonical refs).

On a CUDA backend (its ``device`` attribute) every fused pass runs on the
executor thread with THAT device made current (the thread's own current
device is whatever CUDA gave it), and the tier waits for the device's
current stream before any future resolves: a caller reading the result
tensors on another thread or stream reads finished memory.

Two usage surfaces over one implementation:

* **async** — ``await tier.submit(tenant, plan)`` inside a running event
  loop (``await tier.aclose()`` to shut down);
* **threaded** — ``tier.start()`` hosts the loop in a daemon thread;
  ``tier.submit_sync`` blocks for the result, ``tier.submit_nowait``
  returns a ``concurrent.futures.Future`` (the open-loop load generator's
  entry point), ``tier.shutdown()`` drains and joins.  The tier is also a
  context manager: ``with ServingTier(backend) as tier: ...``.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.provenance.plan import QueryPlan
from repro_torch.serve.admission import AdmissionController, TierClosedError

__all__ = ["ServingTier"]


@dataclasses.dataclass
class _Request:
    """One admitted plan riding a bucket toward a fused pass.

    ``future`` is EITHER an ``asyncio.Future`` (async ``submit``) or a
    ``concurrent.futures.Future`` (threaded burst submission) — both are
    settled from the loop thread, where asyncio futures require it and
    concurrent futures are thread-safe anyway."""

    tenant: str
    plan: QueryPlan
    future: object
    t_submit: float


class ServingTier:
    """Bounded, capability-scoped, micro-batching front door over one
    query backend.

    Tuning knobs:

    ``max_batch``
        flush a bucket at this many plans (the fusion width cap);
    ``max_wait_ms``
        flush a non-full bucket once its oldest plan has waited this long
        (the latency bound a lone probe pays for batching);
    ``max_queue`` / ``max_inflight_per_tenant``
        admission bounds (see :mod:`repro_torch.serve.admission`).
    """

    def __init__(self, backend, *,
                 max_batch: int = 32,
                 max_wait_ms: float = 2.0,
                 max_queue: int = 1024,
                 max_inflight_per_tenant: Optional[int] = None,
                 allow_unregistered: bool = True,
                 name: str = "tier") -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.backend = backend
        self.name = name
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.admission = AdmissionController(
            max_queue, max_inflight_per_tenant, allow_unregistered)
        self.counters: Dict[str, int] = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "batches": 0,
            "batched_plans": 0,
            "flush_full": 0,
            "flush_timer": 0,
            "flush_drain": 0,
            "convoys": 0,
            "max_batch_seen": 0,
        }
        self._buckets: Dict[Tuple, List[_Request]] = {}
        self._timers: Dict[Tuple, "asyncio.TimerHandle"] = {}
        self._ready: Optional[asyncio.Queue] = None
        self._space: Optional[asyncio.Event] = None
        self._executor_task: Optional[asyncio.Task] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{name}-exec")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    # -- tenants ---------------------------------------------------------------
    def register_tenant(self, name: str, scope=None,
                        max_inflight: Optional[int] = None) -> "ServingTier":
        """Register a tenant with a capability scope (``None`` =
        unrestricted, a ``BoundaryHandle``, a :class:`~repro_torch.serve.\
admission.TenantScope`, or an iterable of allowed refs) and an optional
        in-flight cap."""
        self.admission.register(name, scope, max_inflight)
        return self

    # -- async core ------------------------------------------------------------
    def _ensure_loop_state(self) -> None:
        if self._ready is None:
            self._ready = asyncio.Queue()
            self._space = asyncio.Event()

    async def serve(self) -> None:
        """Bind the tier to the RUNNING event loop and start the batch
        executor.  Called automatically by the first ``submit`` (async use)
        or by :meth:`start` (threaded use)."""
        self._loop = asyncio.get_running_loop()
        self._ensure_loop_state()
        if self._executor_task is None or self._executor_task.done():
            self._executor_task = self._loop.create_task(self._executor())

    async def submit(self, tenant: str, plan, *, wait: bool = False):
        """Admit one plan for ``tenant`` and return its result.

        Raises the typed admission errors
        (:class:`~repro_torch.serve.admission.QueueFullError`,
        :class:`~repro_torch.serve.admission.TenantOverloadError`,
        :class:`~repro_torch.serve.admission.TierClosedError`) or
        :class:`~repro_torch.provenance.catalog.CapabilityError` on an
        out-of-scope ref.  ``wait=True`` turns the queue-full rejection
        into backpressure: the submission blocks until capacity frees.
        """
        fut = await self._enqueue(tenant, plan, wait=wait)
        return await fut

    async def _enqueue(self, tenant: str, plan, *,
                       wait: bool = False) -> "asyncio.Future":
        if self._executor_task is None or self._executor_task.done():
            await self.serve()
        if wait:
            # backpressure: park until a release frees capacity.  The
            # clear-then-wait pair has no await between the predicate check
            # and the wait registration, so a wake-up set by a completion
            # callback (which only runs between awaits on this loop) can
            # never be lost.
            while not (self.admission.has_capacity(tenant)
                       or self.admission.closed):
                self._space.clear()
                await self._space.wait()
        return self._admit_and_bucket(tenant, plan)

    def _admit_and_bucket(self, tenant: str, plan,
                          future=None) -> "asyncio.Future":
        """The synchronous enqueue core (loop thread only): normalize,
        admit, bucket, flush-or-arm-timer.  ``future`` lets the burst path
        ride a pre-made ``concurrent.futures.Future`` straight through —
        no per-request chaining callback."""
        plan = plan if isinstance(plan, QueryPlan) else plan.plan()
        prepare = getattr(self.backend, "prepare", None)
        if prepare is not None:
            plan = prepare(plan)
        self.admission.admit(tenant, plan)     # raises the typed rejections
        self.counters["submitted"] += 1
        req = _Request(tenant, plan,
                       self._loop.create_future() if future is None
                       else future,
                       time.perf_counter())
        key = plan.fuse_key()
        bucket = self._buckets.setdefault(key, [])
        bucket.append(req)
        if len(bucket) >= self.max_batch:
            self._flush(key, "flush_full")
        elif len(bucket) == 1:
            self._timers[key] = self._loop.call_later(
                self.max_wait_ms / 1e3, self._flush, key, "flush_timer")
        return req.future

    def _release_batch(self, batch: List[_Request], failed: bool) -> None:
        """Admission bookkeeping for a settled batch, in ONE pass (loop
        thread) — per-future done-callbacks would cost a loop hop per
        request at saturation."""
        for r in batch:
            self.admission.release(r.tenant)
        self.counters["failed" if failed else "completed"] += len(batch)
        if self._space is not None:
            self._space.set()       # wake any backpressured submitters

    def _flush(self, key: Tuple, reason: str) -> None:
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        batch = self._buckets.pop(key, None)
        if not batch:
            return
        self.counters[reason] += 1
        self.counters["batches"] += 1
        self.counters["batched_plans"] += len(batch)
        self.counters["max_batch_seen"] = max(
            self.counters["max_batch_seen"], len(batch))
        self._ready.put_nowait(batch)

    def _flush_all(self, reason: str = "flush_drain") -> None:
        for key in list(self._buckets):
            self._flush(key, reason)

    def _run_many(self, plans: List[QueryPlan]) -> List:
        """One fused pass, on the executor thread.  A CUDA backend runs with
        its own device current and is waited for (its current stream)
        before the results leave the thread."""
        dev = getattr(self.backend, "device", None)
        if dev is None or torch.device(dev).type != "cuda":
            return self.backend.run_many(plans)
        dev = torch.device(dev)
        with torch.cuda.device(dev):
            results = self.backend.run_many(plans)
            torch.cuda.current_stream(dev).synchronize()
        return results

    async def _executor(self) -> None:
        """Drain ready batches: everything already flushed rides ONE
        ``backend.run_many`` call on the (single-threaded) pool — a convoy
        of same-key batches still splits into per-key fused passes inside
        ``run_many``, and distinct-key batches share the pass overhead.
        The pool serializes backend access, so the shared session never
        sees concurrency while the event loop keeps admitting the next
        wave."""
        while True:
            batch = await self._ready.get()
            if batch is None:       # shutdown sentinel
                self._ready.task_done()
                return
            batches = [batch]
            while True:             # convoy: grab every batch already ready
                try:
                    nxt = self._ready.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is None:     # keep the sentinel for the next round
                    self._ready.put_nowait(None)
                    self._ready.task_done()
                    break
                batches.append(nxt)
            if len(batches) > 1:
                self.counters["convoys"] += 1
            plans = [r.plan for b in batches for r in b]
            try:
                results = await self._loop.run_in_executor(
                    self._pool, self._run_many, plans)
            except Exception as exc:        # noqa: BLE001 — fan the real
                for b in batches:           # error out to every caller
                    for r in b:
                        if not r.future.done():
                            r.future.set_exception(exc)
                    self._release_batch(b, failed=True)
            else:
                it = iter(results)
                for b in batches:
                    for r in b:
                        res = next(it)
                        if not r.future.done():
                            r.future.set_result(res)
                    self._release_batch(b, failed=False)
            finally:
                for _ in batches:
                    self._ready.task_done()

    async def aclose(self, drain: bool = True) -> None:
        """Stop admitting; ``drain=True`` executes everything already
        admitted before returning, ``drain=False`` rejects it."""
        self.admission.closed = True
        if self._loop is None:
            return
        if drain:
            self._flush_all()
            await self._ready.join()
        else:
            self._flush_all()
            while not self._ready.empty():
                batch = self._ready.get_nowait()
                if batch:
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(TierClosedError(
                                "tier shut down without draining"))
                    self._release_batch(batch, failed=True)
                self._ready.task_done()
        if self._executor_task is not None and not self._executor_task.done():
            self._ready.put_nowait(None)
            await self._executor_task
        self._space.set()           # release any backpressured waiters

    # -- threaded facade ---------------------------------------------------------
    def start(self) -> "ServingTier":
        """Host the tier's event loop in a daemon thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self

        def _run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def _main() -> None:
                await self.serve()
                self._started.set()
                await self._stop_event.wait()

            self._stop_event = asyncio.Event()
            try:
                loop.run_until_complete(_main())
            finally:
                loop.close()

        self._started.clear()
        self._thread = threading.Thread(
            target=_run, name=f"{self.name}-loop", daemon=True)
        self._thread.start()
        self._started.wait()
        return self

    def _require_thread_loop(self) -> asyncio.AbstractEventLoop:
        if self._thread is None or not self._thread.is_alive() \
                or self._loop is None:
            raise TierClosedError(
                "tier loop is not running: call start() (threaded use) or "
                "submit from inside an event loop (async use)")
        return self._loop

    def submit_nowait(self, tenant: str, plan, *,
                      wait: bool = False) -> "concurrent.futures.Future":
        """Submit from any thread; returns a ``concurrent.futures.Future``
        for the result.  Admission errors surface on the future.

        The default (reject-on-full) path is a single ``call_soon`` hop —
        no coroutine per request, so an open-loop load generator can
        sustain tens of thousands of submissions per second.  ``wait=True``
        needs the async backpressure machinery and pays the coroutine."""
        loop = self._require_thread_loop()
        if wait:
            async def _go():
                fut = await self._enqueue(tenant, plan, wait=True)
                return await fut

            return asyncio.run_coroutine_threadsafe(_go(), loop)

        cfut: "concurrent.futures.Future" = concurrent.futures.Future()

        def _one() -> None:
            try:
                self._admit_and_bucket(tenant, plan, future=cfut)
            except Exception as exc:        # noqa: BLE001 — typed admission
                cfut.set_exception(exc)

        loop.call_soon_threadsafe(_one)
        return cfut

    def submit_many_nowait(
            self, tenant: str, plans) -> List["concurrent.futures.Future"]:
        """Burst submission: enqueue a whole list of plans in ONE hop onto
        the loop thread (a single ``call_soon_threadsafe``), so high-rate
        injection pays one scheduling round-trip per burst instead of one
        per request.  Per-plan admission still applies — a rejected plan
        surfaces its typed error on ITS future without failing the rest."""
        loop = self._require_thread_loop()
        cfuts = [concurrent.futures.Future() for _ in plans]

        def _go() -> None:
            for plan, cfut in zip(plans, cfuts):
                try:
                    self._admit_and_bucket(tenant, plan, future=cfut)
                except Exception as exc:    # noqa: BLE001 — typed admission
                    cfut.set_exception(exc)

        loop.call_soon_threadsafe(_go)
        return cfuts

    def submit_sync(self, tenant: str, plan, *, wait: bool = False,
                    timeout: Optional[float] = None):
        """Blocking submit from any thread (the drop-in replacement for a
        direct ``session.run`` call)."""
        return self.submit_nowait(tenant, plan, wait=wait).result(timeout)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = 60.0) -> None:
        """Threaded-mode shutdown: close admission, drain (or reject), stop
        the loop thread, and tear down the executor pool."""
        if self._thread is None or self._loop is None:
            self.admission.closed = True
            self._pool.shutdown(wait=False)
            return
        loop = self._loop
        done = asyncio.run_coroutine_threadsafe(self.aclose(drain), loop)
        done.result(timeout)
        loop.call_soon_threadsafe(self._stop_event.set)
        self._thread.join(timeout)
        self._thread = None
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ServingTier":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    # -- introspection -----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Tier counters + admission counters (+ backend stats when the
        backend exposes them) — the serving-path observability surface."""
        out: Dict[str, object] = {
            "tier": dict(self.counters),
            "admission": self.admission.stats(),
            "queued_buckets": len(self._buckets),
        }
        backend_stats = getattr(self.backend, "stats", None)
        if callable(backend_stats):
            try:
                out["backend"] = backend_stats()
            except Exception:       # noqa: BLE001 — stats must never raise
                pass
        return out
