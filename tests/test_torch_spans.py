"""The port's span recorder (``repro_torch.core.spans``) and its host-sync
counter, on the CPU.

The recorder: off, ``span`` hands back one shared no-op and nothing is
kept; on, nested spans aggregate by path with self time and counters,
threads keep separate stacks, a tracked op gives ``capture.<op>`` with
``capture.op`` and ``capture.record`` inside, and ``torch.profiler`` sees
the spans as ranges only while a recording is open.

The counter: over one B = 64 call of each of Q1-Q4 (after a first call of
the same kind, which packs the attribute planes on the host) on Compas
and on a cut TPC-DI join, and over one cut TPC-DI capture, ``host_syncs``
equals an independent count of the operations that wait for the card,
taken by a ``TorchFunctionMode``: ``nonzero``, ``.item()``, ``bool()``,
``int()``, ``float()``, ``.tolist()``, ``unique``, ``equal``, a boolean
index, and ``bincount`` (two reads of a non-empty input on the card).
Copies from the host, which the CPU does not make, are counted on the
card alone; there the counter is held to ``torch.cuda``'s sync debug mode.
"""
import collections
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import spans
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as U
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import QuerySession, prov

CPU = "cpu"
B = 64


class SyncOps(TorchFunctionMode):
    """Counts the calls that make the host wait for the card."""

    ONE = {torch.nonzero, torch.Tensor.nonzero, torch.Tensor.item, torch.Tensor.__bool__,
           torch.Tensor.__int__, torch.Tensor.__float__, torch.Tensor.tolist,
           torch.unique, torch.Tensor.unique, torch.equal}

    def __init__(self):
        super().__init__()
        self.n = 0
        self.by_op = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        n = 0
        if func in self.ONE:
            n = 1
        elif func in (torch.bincount, torch.Tensor.bincount):
            n = 2 if args[0].numel() else 0
        elif func is torch.Tensor.__getitem__:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            n = int(any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx))
        if n:
            self.n += n
            self.by_op[getattr(func, "__name__", str(func))] += n
        return func(*args, **(kwargs or {}))


def syncs(summary, root=None) -> int:
    """``host_syncs`` under the spans rooted at ``root`` (all, with None)."""
    return sum(v["counters"].get(spans.HOST_SYNCS, 0) for p, v in summary["spans"].items()
               if root is None or p.split("/", 1)[0] == root)


# -- the recorder ---------------------------------------------------------------
def test_off_is_one_shared_noop():
    assert spans._rec is None
    a, b = spans.span("x"), spans.span("y", CPU)
    assert a is b
    with a:
        spans.count("n", 5)
        spans.count_host_copy("cuda")
    with spans.recording() as rec:
        pass
    assert rec.summary() == {"spans": {}, "loose": {}}


def test_nesting_self_time_and_counts():
    with spans.recording() as rec:
        spans.count("n", 2)                     # outside every span
        for _ in range(3):
            with spans.span("a"):
                spans.count("n")
                with spans.span("b"):
                    spans.count("n", 4)
                    with spans.span("c", CPU):
                        pass
                with spans.span("b"):
                    pass
    assert spans._rec is None
    sm = rec.summary()
    sp = sm["spans"]
    assert set(sp) == {"a", "a/b", "a/b/c"}
    assert sm["loose"] == {"n": 2}
    assert [sp[p]["count"] for p in ("a", "a/b", "a/b/c")] == [3, 6, 3]
    assert sp["a"]["counters"] == {"n": 3}
    assert sp["a/b"]["counters"] == {"n": 12}
    assert sp["a/b/c"]["counters"] == {}
    assert sp["a"]["self_ns"] == sp["a"]["host_ns"] - sp["a/b"]["host_ns"]
    assert sp["a/b"]["self_ns"] == sp["a/b"]["host_ns"] - sp["a/b/c"]["host_ns"]
    assert sp["a/b/c"]["self_ns"] == sp["a/b/c"]["host_ns"] > 0
    # a span on the CPU takes its host time as its device time; one given
    # no device has none
    assert sp["a/b/c"]["device_ns"] == sp["a/b/c"]["host_ns"]
    assert sp["a"]["device_ns"] is None and sp["a/b"]["device_ns"] is None


def test_host_copies_count_off_the_cpu_alone():
    with spans.recording() as rec:
        with spans.span("a"):
            spans.count_host_copy("cuda", 3)
            spans.count_host_copy(torch.device("cuda", 0))
            spans.count_host_copy(CPU, 5)
    assert rec.summary()["spans"]["a"]["counters"] == {spans.HOST_SYNCS: 4}


def test_nested_recording_starts_empty_and_restores():
    with spans.recording() as outer:
        with spans.span("a"):
            with spans.recording() as inner:
                with spans.span("b"):
                    pass
            with spans.span("c"):
                pass
    assert set(inner.summary()["spans"]) == {"a/b"}
    assert set(outer.summary()["spans"]) == {"a", "a/c"}


def test_threads_keep_separate_stacks():
    both_open = threading.Barrier(2)
    inner_done = threading.Barrier(2)

    def work(name):
        with spans.span(name):
            both_open.wait()
            with spans.span("inner"):
                spans.count("n")
            inner_done.wait()

    with spans.recording() as rec:
        threads = [threading.Thread(target=work, args=(n,)) for n in ("one", "two")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    sp = rec.summary()["spans"]
    assert set(sp) == {"one", "two", "one/inner", "two/inner"}
    assert sp["one/inner"]["counters"] == sp["two/inner"]["counters"] == {"n": 1}


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_profiler_sees_spans_only_while_recording():
    def work():
        with spans.span("session.run"):
            with spans.span("session.extract"):
                torch.nonzero(torch.ones(4))

    assert not {"session.run", "session.extract"} & _profiled_names(work)

    def recorded():
        with spans.recording():
            work()

    assert {"session.run", "session.extract"} <= _profiled_names(recorded)


# -- the capture spans ------------------------------------------------------------
def _tpcdi_tables(seed=1, n_left=3000, n_right=3300):
    """TPC-DI's trade x security join at a cut size: 21 and 15 columns,
    many trades to a security."""
    rng = np.random.default_rng(seed)
    left = {"key": rng.integers(0, n_right, n_left).astype(np.float32),
            **{f"l{j}": rng.normal(size=n_left).astype(np.float32) for j in range(20)}}
    right = {"key": np.arange(n_right, dtype=np.float32),
             **{f"r{j}": rng.normal(size=n_right).astype(np.float32) for j in range(14)}}
    return Table.from_columns(left, device=CPU), Table.from_columns(right, device=CPU)


def _capture_tpcdi(left, right):
    idx = ProvenanceIndex("tpcdi", device=CPU)
    joined = track(left, idx, "trade").join(track(right, idx, "security"), on="key")
    sink = joined.filter_rows(joined.table.col("l0") > 0).mark_sink()
    return idx, sink.dataset_id


def test_tracked_ops_give_capture_spans():
    left, right = _tpcdi_tables()
    with spans.recording() as rec:
        _capture_tpcdi(left, right)
    sp = rec.summary()["spans"]
    assert set(sp) == {f"capture.{op}{part}" for op in ("join", "filter_rows")
                       for part in ("", "/capture.op", "/capture.record")}
    for op in ("capture.join", "capture.filter_rows"):
        assert sp[op]["count"] == 1
        kids = sp[f"{op}/capture.op"]["host_ns"] + sp[f"{op}/capture.record"]["host_ns"]
        assert sp[op]["self_ns"] == sp[op]["host_ns"] - kids
        for p in (op, f"{op}/capture.op", f"{op}/capture.record"):
            assert sp[p]["device_ns"] == sp[p]["host_ns"]


def test_capture_host_syncs_match_sync_ops():
    left, right = _tpcdi_tables()
    _capture_tpcdi(left, right)
    mode = SyncOps()
    with spans.recording() as rec:
        with mode:
            _capture_tpcdi(left, right)
    sm = rec.summary()
    assert sm["loose"] == {}
    # the join's total and the filter's nonzero
    assert syncs(sm, "capture.join") == syncs(sm, "capture.filter_rows") == 1
    assert syncs(sm) == mode.n, mode.by_op


# -- the query spans and the counter ------------------------------------------------
@pytest.fixture(scope="module")
def indexes():
    compas = ProvenanceIndex("compas", device=CPU)
    c_sink = U.run_compas(compas, U.make_compas(device=CPU)).dataset_id
    tpcdi, t_sink = _capture_tpcdi(*_tpcdi_tables())
    return {"compas": (compas, ["compas_src"], c_sink), "tpcdi": (tpcdi, ["trade", "security"], t_sink)}


def _plan(index, q, src, sink, rng):
    start = src if q in ("q1", "q3") else sink
    n_rows, n_cols = index.datasets[start].n_rows, index.datasets[start].n_cols
    b = prov(index)
    b = b.source(src).forward().to(sink) if q in ("q1", "q3") else \
        b.source(sink).backward().to(src)
    b = b.rows_batch(np.stack([rng.choice(n_rows, 8, replace=False) for _ in range(B)]))
    if q in ("q3", "q4"):
        b = b.attrs_batch(np.stack([rng.choice(n_cols, 4, replace=False) for _ in range(B)]))
    return b.plan()


KINDS = [("compas", q, 0) for q in ("q1", "q2", "q3", "q4")] + \
    [("tpcdi", q, 0) for q in ("q1", "q2", "q3", "q4")] + [("tpcdi", q, 1) for q in ("q1", "q2")]


@pytest.mark.parametrize("fused_walk", [None, True])
@pytest.mark.parametrize("config,q,src", KINDS)
def test_query_host_syncs_match_sync_ops(indexes, config, q, src, fused_walk):
    index, sources, sink = indexes[config]
    session = QuerySession(index, fused_walk=fused_walk)
    rng = np.random.default_rng(7)
    session.run(_plan(index, q, sources[src], sink, rng))
    plan = _plan(index, q, sources[src], sink, rng)
    mode = SyncOps()
    with spans.recording() as rec:
        with mode:
            got = session.run(plan)
    sm = rec.summary()
    sp = sm["spans"]
    assert sp["session.run"]["count"] == 1
    assert {"session.run/session.route", "session.run/session.execute",
            "session.run/session.extract"} <= set(sp)
    assert sm["loose"] == {}
    assert syncs(sm, "session.run") == mode.n, mode.by_op
    if q in ("q1", "q2"):
        # one read of the per-probe counts for the whole batch
        assert sp["session.run/session.extract"]["counters"][spans.HOST_SYNCS] == 1
    assert len(got) == B


def test_spans_leave_answers_alone(indexes):
    index, sources, sink = indexes["compas"]
    session = QuerySession(index)
    for q in ("q1", "q2", "q3", "q4"):
        plan = _plan(index, q, sources[0], sink, np.random.default_rng(3))
        want = session.run(plan)
        with spans.recording():
            got = session.run(plan)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
