"""The attribute walk's spans and counter in the port, on Census cut to 300
rows, on the CPU.

Census (UCI Adult through mean impute, z-score and three one-hot ops, 15
columns to 104) at Adult's categorical domains, so that every one-hot
column can be set.  One B = 16 call of each of Q3, Q4, Q7 and Q8, after a
first call of the same kind (which packs the attribute planes on the
host), inside ``spans.recording()``:

* each (op, input, term) hop of the walk opens one ``query.attr_hop`` span
  and counts one ``attr_hops``: as many as ``bitplane_or_reduce``
  dispatches, 5 a call on the 5-op chain;
* each traced hop of Q7/Q8 opens one ``query.how_trace`` span holding one
  ``host_syncs``; Q3/Q4 open none;
* the answers are the same with the recorder on and off, and equal to the
  JAX package's.
"""
import numpy as np
import pytest

from repro.core.hopcache import ComposedIndex
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import usecases as RU
from repro.dataprep.table import Table as RTable
from repro.provenance import QuerySession as RSession
from repro.provenance import prov as rprov
from repro_torch.core import query as TQ
from repro_torch.core import spans
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as TU
from repro_torch.dataprep.table import Table
from repro_torch.provenance import prov

CPU = "cpu"
N_ROWS, B = 300, 16
DOMAINS = (9, 16, 64, 7, 15, 6, 5, 2, 2)       # a0-a8, Adult's categorical columns
KINDS = ("q3", "q4", "q7", "q8")


def census_columns(seed: int = 0):
    rng = np.random.default_rng(seed)
    cols, nulls = {}, {}
    for j in range(15):
        if j < len(DOMAINS):
            cols[f"a{j}"] = rng.integers(0, DOMAINS[j], N_ROWS).astype(np.float32)
        else:
            cols[f"a{j}"] = rng.normal(size=N_ROWS).astype(np.float32)
        nulls[f"a{j}"] = rng.random(N_ROWS) < 0.02
    return cols, nulls


@pytest.fixture(scope="module")
def census():
    cols, nulls = census_columns()
    r_idx = RIndex("census")
    r_sink = RU.run_census(r_idx, RTable.from_columns(cols, null=nulls)).dataset_id
    t_idx = ProvenanceIndex("census", device=CPU)
    t_sink = TU.run_census(t_idx, Table.from_columns(cols, null=nulls, device=CPU)).dataset_id
    assert t_idx.datasets[t_sink].n_cols == 104
    return r_idx, r_sink, t_idx, t_sink


def probes(n_rows, n_cols, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, size=(B, 8))
    attrs = np.argsort(rng.random((B, n_cols)), axis=1)[:, :4]
    return rows, attrs


def query(p, kind, src, sink, rows, attrs):
    q = p.source(src).forward().to(sink) if kind in ("q3", "q7") \
        else p.source(sink).backward().to(src)
    q = q.rows_batch(rows).attrs_batch(attrs)
    return q.how() if kind in ("q7", "q8") else q


def call(census, kind, seed=1):
    """The port's answer to one call of ``kind``, after a first call of the
    same kind, and its recording."""
    _, _, t_idx, t_sink = census
    start = t_idx.datasets["census_src" if kind in ("q3", "q7") else t_sink]
    rows, attrs = probes(start.n_rows, start.n_cols, seed)
    session = t_idx.session()
    session.run(query(prov(t_idx), kind, "census_src", t_sink, rows, attrs).plan())
    with spans.recording() as rec:
        got = session.run(query(prov(t_idx), kind, "census_src", t_sink, rows, attrs).plan())
    return got, rec.summary()["spans"], (rows, attrs)


def named(summary, name):
    return [s for path, s in summary.items() if path.rsplit("/", 1)[-1] == name]


@pytest.mark.parametrize("kind", ["q3", "q4"])
def test_attr_hops_count_bitplane_dispatches(census, kind, monkeypatch):
    calls = []
    real = TQ.bitplane_or_reduce
    monkeypatch.setattr(TQ, "bitplane_or_reduce", lambda *a: calls.append(1) or real(*a))
    _, summary, _ = call(census, kind)
    hops = named(summary, "query.attr_hop")
    n_hops = sum(s["counters"].get(TQ.ATTR_HOPS, 0) for s in summary.values())
    assert len(calls) == 10           # the first call's and the recorded one's
    assert n_hops == sum(s["count"] for s in hops) == 5
    assert all(s["device_ns"] is not None for s in hops)


@pytest.mark.parametrize("kind", ["q7", "q8"])
def test_how_trace_counts_one_sync_a_hop(census, kind):
    got, summary, _ = call(census, kind)
    traces = named(summary, "query.how_trace")
    assert sum(s["count"] for s in traces) == 5
    assert sum(s["counters"].get(spans.HOST_SYNCS, 0) for s in traces) == 5
    assert all(len(hops) == 5 for _, hops in got)
    assert sum(s["counters"].get(TQ.ATTR_HOPS, 0) for s in summary.values()) == 5


@pytest.mark.parametrize("kind", ["q3", "q4"])
def test_no_how_trace_for_cells(census, kind):
    _, summary, _ = call(census, kind)
    assert not named(summary, "query.how_trace")
    assert named(summary, "query.attr_hop")


def _plain(answer):
    if isinstance(answer, tuple):
        cells, hops = answer
        return cells.numpy(), [(h.op_id, h.op_name, h.category, h.n_records) for h in hops]
    return answer.numpy(), None


@pytest.mark.parametrize("kind", KINDS)
def test_answers_same_with_recorder_on_and_off(census, kind):
    r_idx, r_sink, t_idx, t_sink = census
    got, _, (rows, attrs) = call(census, kind, seed=2)
    off = t_idx.session().run(query(prov(t_idx), kind, "census_src", t_sink, rows, attrs).plan())
    rs = RSession(r_idx, ComposedIndex(r_idx), use_hopcache=False, fused_walk=False)
    want = query(rprov(r_idx), kind, "census_src", r_sink, rows, attrs).run(rs)
    assert len(got) == len(off) == len(want) == B
    for g, o, w in zip(got, off, want):
        (gc, gh), (oc, oh) = _plain(g), _plain(o)
        wc = np.asarray(w[0] if isinstance(w, tuple) else w)
        assert np.array_equal(gc, oc) and gh == oh
        assert gc.dtype == np.int64 and np.array_equal(gc, wc)
        if gh is not None:
            assert gh == [(h.op_id, h.op_name, h.category, h.n_records) for h in w[1]]
    assert any(len(_plain(g)[0]) for g in got)
