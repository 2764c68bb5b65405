"""The port's serving tier against ``repro``'s, scenario for scenario.

Twins of the tier tests of ``tests/test_serving.py`` (burst parity and
fused batches, the timer flush, the async surface, the queue bound and
backpressure, tenant caps, capability scoping, ``submit_many`` isolation,
drain and no-drain shutdown, backend failure).  Each scenario runs once in
each package on the same numpy inputs and the same plans: every answer must
equal its own session's ``run`` and the other package's answer, and the
tier counters and typed rejections must be the same.  Two more scenarios
put a ``FederatedSession`` and a ``BoundaryHandle`` behind the tier.  The
``ServeEngine`` tests of ``test_serving.py`` wait for the LM substrate.

An autouse SIGALRM fixture aborts a wedged tier instead of hanging the
suite.
"""
import asyncio
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

import pipegen
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as rtrack
from repro.provenance import CapabilityError as RCapabilityError
from repro.provenance import prov as rprov
from repro.serve import admission as radm
from repro.serve.tier import ServingTier as RTier
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import CapabilityError, prov
from repro_torch.serve import (
    QueueFullError,
    ServingTier,
    TenantOverloadError,
    TenantScope,
    TierClosedError,
)
from test_torch_federation import build_federated

DEADLINE_S = 120
CPU = "cpu"

R = types.SimpleNamespace(
    name="repro", Index=RIndex, track=rtrack, prov=rprov, Tier=RTier,
    table=lambda cols: RTable.from_columns(cols), mask=lambda m: m,
    QueueFullError=radm.QueueFullError, TenantOverloadError=radm.TenantOverloadError,
    TierClosedError=radm.TierClosedError, TenantScope=radm.TenantScope,
    CapabilityError=RCapabilityError)
T = types.SimpleNamespace(
    name="port", Index=lambda name: ProvenanceIndex(name, device=CPU), track=track, prov=prov,
    Tier=ServingTier, table=lambda cols: Table.from_columns(cols, device=CPU),
    mask=torch.from_numpy,
    QueueFullError=QueueFullError, TenantOverloadError=TenantOverloadError,
    TierClosedError=TierClosedError, TenantScope=TenantScope, CapabilityError=CapabilityError)


@pytest.fixture(autouse=True)
def _deadline():
    """Abort (don't hang) a wedged serving test.  SIGALRM only works on
    the main thread of a POSIX process; anywhere else this is a no-op."""
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _boom(signum, frame):
        raise TimeoutError(f"serving test exceeded {DEADLINE_S}s deadline")

    old = signal.signal(signal.SIGALRM, _boom)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# Fixtures, built the same way in either package
# ---------------------------------------------------------------------------
def _chain_index(pkg, seed=0, n=48):
    """raw -> scaled -> sink chain plus a SIBLING branch off raw (not an
    ancestor of sink — the out-of-scope ref for capability tests)."""
    rng = np.random.default_rng(seed)
    idx = pkg.Index(f"serving-test-{seed}")
    s = pkg.track(pkg.table({
        "k": np.arange(n, dtype=np.float32),
        "x": rng.normal(size=n).astype(np.float32),
    }), idx, "raw")
    scaled = s.value_transform("x", "scale", factor=2.0)
    sibling = s.value_transform("x", "scale", factor=-1.0)
    sink = scaled.filter_rows(pkg.mask(rng.random(n) > 0.25))
    sink.mark_sink()
    return idx, sink.dataset_id, sibling.dataset_id


def _mixed_plans(pkg, idx, sink, n_plans, seed=1, src="raw"):
    """Round-robin Q1/Q2/Q4 single-probe plans — three fuse keys."""
    rng = np.random.default_rng(seed)
    n_raw = idx.datasets[src].n_rows
    n_sink = idx.datasets[sink].n_rows
    plans = []
    for i in range(n_plans):
        if i % 3 == 0:
            plans.append(pkg.prov(idx).source(src).rows([int(rng.integers(n_raw))])
                         .forward().to(sink).plan())
        elif i % 3 == 1:
            plans.append(pkg.prov(idx).source(sink).rows([int(rng.integers(n_sink))])
                         .backward().to(src).plan())
        else:
            plans.append(pkg.prov(idx).source(sink).rows([int(rng.integers(n_sink))])
                         .attrs([0]).backward().to(src).plan())
    return plans


def _np(x):
    if isinstance(x, list):
        return [_np(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_parity(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        la = a if isinstance(a, list) else [a]
        lb = b if isinstance(b, list) else [b]
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(_np(x), _np(y))


def _poll(pred, timeout=30.0, what="condition"):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what} not reached within {timeout}s")
        time.sleep(0.005)


class _GatedBackend:
    """``run_many`` blocks until the gate opens — keeps admitted requests
    in flight so the admission bounds become observable from a test."""

    def __init__(self, session):
        self.session = session
        self.gate = threading.Event()
        self.calls = 0

    def run_many(self, plans):
        self.gate.wait(DEADLINE_S)
        self.calls += 1
        return self.session.run_many(plans)


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` in both packages; their outcomes (answers
    as numpy, counters, error names) must be equal."""
    want = scenario(R, *args)
    got = scenario(T, *args)
    _assert_parity(want["answers"], got["answers"])
    assert {k: v for k, v in got.items() if k != "answers"} == \
        {k: v for k, v in want.items() if k != "answers"}
    return got


# ===========================================================================
# Fusion parity + batching
# ===========================================================================
def _burst(pkg):
    idx, sink, _ = _chain_index(pkg)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 48)
    ref = [sess.run(p) for p in plans]
    with pkg.Tier(sess, max_batch=16, max_wait_ms=5.0) as tier:
        futs = tier.submit_many_nowait("burst", plans)
        got = [f.result(timeout=60) for f in futs]
        st = tier.stats()["tier"]
    _assert_parity(ref, got)
    assert st["submitted"] == st["completed"] == 48
    assert st["batched_plans"] == 48
    assert st["batches"] < 48
    assert st["max_batch_seen"] == 16
    assert st["flush_full"] >= 3
    return {"answers": got, "max_batch_seen": st["max_batch_seen"]}


def test_tier_burst_parity_and_fused_batches():
    _both(_burst)


def _timer(pkg):
    idx, sink, _ = _chain_index(pkg)
    sess = idx.session()
    plan = _mixed_plans(pkg, idx, sink, 1)[0]
    with pkg.Tier(sess, max_batch=64, max_wait_ms=1.0) as tier:
        got = tier.submit_sync("lone", plan, timeout=30)
        st = tier.stats()["tier"]
    _assert_parity([sess.run(plan)], [got])
    assert st["flush_timer"] == 1 and st["flush_full"] == 0
    return {"answers": [got], "flushes": (st["flush_timer"], st["flush_full"])}


def test_tier_single_probe_timer_flush():
    _both(_timer)


def _async(pkg):
    idx, sink, _ = _chain_index(pkg, seed=2)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 12, seed=3)
    ref = [sess.run(p) for p in plans]

    async def main():
        tier = pkg.Tier(sess, max_batch=4, max_wait_ms=1.0)
        got = await asyncio.gather(
            *[tier.submit(f"t{i % 2}", p) for i, p in enumerate(plans)])
        await tier.aclose()
        return got

    got = asyncio.run(main())
    _assert_parity(ref, got)
    return {"answers": list(got)}


def test_tier_async_surface_parity():
    _both(_async)


# ===========================================================================
# Admission: bounds, backpressure, typed rejection
# ===========================================================================
def _queue_full(pkg):
    idx, sink, _ = _chain_index(pkg, seed=4)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 6, seed=5)
    backend = _GatedBackend(sess)
    tier = pkg.Tier(backend, max_batch=1, max_wait_ms=0.1, max_queue=4).start()
    try:
        futs = [tier.submit_nowait("t", p) for p in plans[:4]]
        _poll(lambda: tier.admission.pending == 4, what="queue fill")
        with pytest.raises(pkg.QueueFullError):
            tier.submit_nowait("t", plans[4]).result(timeout=30)
        assert tier.admission.counters["rejected_queue_full"] == 1
        backend.gate.set()
        got = [f.result(timeout=60) for f in futs]
        _assert_parity([sess.run(p) for p in plans[:4]], got)
        again = tier.submit_sync("t", plans[4], timeout=30)      # capacity freed
        _assert_parity([sess.run(plans[4])], [again])
    finally:
        backend.gate.set()
        tier.shutdown()
    return {"answers": got + [again], "admission": tier.admission.counters}


def test_queue_full_sheds_typed_then_recovers():
    _both(_queue_full)


def _backpressure(pkg):
    idx, sink, _ = _chain_index(pkg, seed=6)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 3, seed=7)
    backend = _GatedBackend(sess)
    tier = pkg.Tier(backend, max_batch=1, max_wait_ms=0.1, max_queue=2).start()
    try:
        futs = [tier.submit_nowait("t", p) for p in plans[:2]]
        _poll(lambda: tier.admission.pending == 2, what="queue fill")
        waiting = tier.submit_nowait("t", plans[2], wait=True)
        time.sleep(0.05)
        assert not waiting.done()       # parked, NOT rejected
        backend.gate.set()
        last = waiting.result(timeout=60)
        _assert_parity([sess.run(plans[2])], [last])
        got = [f.result(timeout=60) for f in futs]
        assert tier.admission.counters["rejected_queue_full"] == 0
    finally:
        backend.gate.set()
        tier.shutdown()
    return {"answers": got + [last]}


def test_wait_turns_rejection_into_backpressure():
    _both(_backpressure)


def _tenant_cap(pkg):
    idx, sink, _ = _chain_index(pkg, seed=8)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 4, seed=9)
    backend = _GatedBackend(sess)
    tier = pkg.Tier(backend, max_batch=1, max_wait_ms=0.1, max_queue=16).start()
    tier.register_tenant("capped", max_inflight=2)
    try:
        futs = [tier.submit_nowait("capped", p) for p in plans[:2]]
        _poll(lambda: tier.admission.pending == 2, what="cap fill")
        with pytest.raises(pkg.TenantOverloadError):
            tier.submit_nowait("capped", plans[2]).result(timeout=30)
        other = tier.submit_nowait("other", plans[3])
        _poll(lambda: tier.admission.pending == 3, what="other admitted")
        backend.gate.set()
        got = [f.result(timeout=60) for f in futs + [other]]
        st = tier.admission.stats()
        assert st["rejected_tenant_cap"] == 1
        assert st["tenants"]["capped"]["rejected"] == 1
        assert st["tenants"]["other"]["rejected"] == 0
    finally:
        backend.gate.set()
        tier.shutdown()
    return {"answers": got, "tenants": st["tenants"]}


def test_tenant_inflight_cap_isolates_tenants():
    _both(_tenant_cap)


# ===========================================================================
# Capability scoping
# ===========================================================================
def _scope(pkg):
    idx, sink, sibling = _chain_index(pkg, seed=10)
    sess = idx.session()
    handle = idx.export(sink)       # ancestor closure: raw, scaled, sink
    tier = pkg.Tier(sess, max_batch=4, max_wait_ms=1.0, allow_unregistered=False).start()
    tier.register_tenant("scoped", handle)
    tier.register_tenant("operator")
    try:
        in_scope = pkg.prov(idx).source(sink).rows([0]).backward().to("raw").plan()
        out_scope = pkg.prov(idx).source(sibling).rows([0]).backward().to("raw").plan()
        a = tier.submit_sync("scoped", in_scope, timeout=30)
        _assert_parity([sess.run(in_scope)], [a])
        with pytest.raises(pkg.CapabilityError):
            tier.submit_sync("scoped", out_scope, timeout=30)
        b = tier.submit_sync("operator", out_scope, timeout=30)
        _assert_parity([sess.run(out_scope)], [b])
        with pytest.raises(pkg.CapabilityError):
            tier.submit_sync("stranger", in_scope, timeout=30)
        st = tier.stats()["admission"]
        assert st["capability_denied"] == 1
        assert st["tenants"]["scoped"]["denied"] == 1
    finally:
        tier.shutdown()
    assert repr(pkg.TenantScope(["a", "b"])) == "TenantScope(2 refs)"
    return {"answers": [a, b], "denied": st["capability_denied"],
            "scope": repr(pkg.TenantScope.from_handle(handle))}


def test_tenant_scope_denies_out_of_scope_refs_at_admission():
    _both(_scope)


def _submit_many(pkg):
    idx, sink, sibling = _chain_index(pkg, seed=11)
    sess = idx.session()
    good = _mixed_plans(pkg, idx, sink, 4, seed=12)
    bad = pkg.prov(idx).source(sibling).rows([0]).backward().to("raw").plan()
    plans = good[:2] + [bad] + good[2:]
    with pkg.Tier(sess, max_batch=8, max_wait_ms=1.0) as tier:
        tier.register_tenant("scoped", idx.export(sink))
        futs = tier.submit_many_nowait("scoped", plans)
        with pytest.raises(pkg.CapabilityError):
            futs[2].result(timeout=30)
        got = [f.result(timeout=60) for f in futs[:2] + futs[3:]]
    _assert_parity([sess.run(p) for p in good], got)
    return {"answers": got}


def test_submit_many_isolates_per_plan_rejection():
    _both(_submit_many)


# ===========================================================================
# Lifecycle: drain, reject, closed
# ===========================================================================
def _drain(pkg):
    idx, sink, _ = _chain_index(pkg, seed=13)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 9, seed=14)
    tier = pkg.Tier(sess, max_batch=64, max_wait_ms=60_000.0).start()
    futs = tier.submit_many_nowait("t", plans)
    _poll(lambda: tier.admission.pending == len(plans), what="bucketed")
    tier.shutdown(drain=True)
    got = [f.result(timeout=1) for f in futs]
    _assert_parity([sess.run(p) for p in plans], got)
    st = tier.stats()
    assert st["tier"]["flush_drain"] >= 1
    assert st["tier"]["completed"] == len(plans)
    assert st["admission"]["pending"] == 0
    with pytest.raises(pkg.TierClosedError):
        tier.submit_nowait("t", plans[0])
    return {"answers": got, "tier": st["tier"]}


def test_shutdown_drain_answers_everything_admitted():
    _both(_drain)


def _no_drain(pkg):
    idx, sink, _ = _chain_index(pkg, seed=15)
    sess = idx.session()
    plans = _mixed_plans(pkg, idx, sink, 6, seed=16)
    tier = pkg.Tier(sess, max_batch=64, max_wait_ms=60_000.0).start()
    futs = tier.submit_many_nowait("t", plans)
    _poll(lambda: tier.admission.pending == len(plans), what="bucketed")
    tier.shutdown(drain=False)
    for f in futs:
        with pytest.raises(pkg.TierClosedError):
            f.result(timeout=1)
    st = tier.stats()
    assert st["tier"]["failed"] == len(plans)
    assert st["admission"]["pending"] == 0
    return {"answers": [], "tier": st["tier"]}


def test_shutdown_without_drain_rejects_queued():
    _both(_no_drain)


def _broken(pkg):
    class _Broken:
        def run_many(self, plans):
            raise RuntimeError("backend exploded")

    idx, sink, _ = _chain_index(pkg, seed=17)
    plans = _mixed_plans(pkg, idx, sink, 3, seed=18)
    with pytest.raises(RuntimeError):
        with pkg.Tier(_Broken(), max_batch=1, max_wait_ms=0.1) as tier:
            futs = [tier.submit_nowait("t", p) for p in plans]
            for f in futs:
                with pytest.raises(RuntimeError, match="backend exploded"):
                    f.result(timeout=30)
            st = tier.stats()["tier"]
            assert st["failed"] == len(plans)
            assert tier.admission.pending == 0
            raise RuntimeError("leave via the exception path")
    return {"answers": [], "failed": st["failed"]}


def test_backend_failure_fans_out_and_releases():
    _both(_broken)


# ===========================================================================
# Backends beyond a single-index session
# ===========================================================================
def _federated(pkg, seed):
    base, specs = pipegen.random_specs(seed)
    cut = len(specs) // 2 or 1
    if pkg is R:
        catalog, refs, sink = pipegen.build_federated(base, specs, cut)
    else:
        catalog, refs, sink = build_federated(base, specs, cut)
    fs = catalog.session()
    plans = _mixed_plans(pkg, catalog, sink, 24, seed=seed, src=refs[0])
    ref = [fs.run(p) for p in plans]
    with pkg.Tier(fs, max_batch=8, max_wait_ms=2.0) as tier:
        got = [f.result(timeout=60) for f in tier.submit_many_nowait("fed", plans)]
        st = tier.stats()["tier"]
    _assert_parity(ref, got)
    assert st["batches"] < len(plans)
    return {"answers": got}


@pytest.mark.parametrize("seed", [0, 3])
def test_federated_session_backend(seed):
    _both(_federated, seed)


def _handle(pkg):
    idx, sink, sibling = _chain_index(pkg, seed=19)
    handle = idx.export(sink)
    plans = _mixed_plans(pkg, idx, sink, 9, seed=20)
    ref = [idx.session().run(p) for p in plans]
    outside = pkg.prov(idx).source(sibling).rows([0]).backward().to("raw").plan()
    with pkg.Tier(handle, max_batch=4, max_wait_ms=0.1) as tier:
        got = [f.result(timeout=60) for f in tier.submit_many_nowait("t", plans)]
        # the handle, not the tier, holds the capability: the plan is
        # admitted and its own pass fails with the typed error
        with pytest.raises(pkg.CapabilityError):
            tier.submit_sync("t", outside, timeout=30)
        st = tier.stats()["tier"]
    _assert_parity(ref, got)
    return {"answers": got, "failed": st["failed"], "completed": st["completed"]}


def test_boundary_handle_backend():
    _both(_handle)


def test_concurrent_clients_stress():
    """More client threads than cores submitting at once, with a short
    switch interval: every admitted request is answered exactly once, the
    admission counters balance, and every answer equals ``session.run``."""
    import sys

    idx, sink, _ = _chain_index(T, seed=21)
    sess = idx.session()
    plans = _mixed_plans(T, idx, sink, 240, seed=22)
    ref = [sess.run(p) for p in plans]
    n_clients = 24
    futs = [None] * len(plans)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingTier(sess, max_batch=8, max_wait_ms=0.5) as tier:
            def client(c):
                for i in range(c, len(plans), n_clients):
                    futs[i] = tier.submit_nowait(f"c{c}", plans[i])

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
                assert not th.is_alive()
            got = [f.result(timeout=60) for f in futs]
            st = tier.stats()
    finally:
        sys.setswitchinterval(old)
    _assert_parity(ref, got)
    assert st["tier"]["submitted"] == st["tier"]["completed"] == len(plans)
    assert st["admission"]["pending"] == 0 and st["admission"]["admitted"] == len(plans)
    assert all(t["inflight"] == 0 for t in st["admission"]["tenants"].values())
