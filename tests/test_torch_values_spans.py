"""A values plan's spans and counters in the port, on TPC-DI's trade x
security join cut to 3,000 x 3,300 rows.

* ``host_syncs`` under ``session.run`` equals an independent count of the
  calls that make the host wait for the card (``test_torch_spans.SyncOps``)
  for Q2 from the sink and Q1 from either source to the join output, which
  the index does not keep, to the sink, which it keeps, and to a join
  output whose left input it does not keep either;
* each call opens one ``recompute.fetch`` span under ``session.run`` that
  counts the rows it recomputes (``recompute_rows``: the distinct answer
  rows), the ops it re-executes (``recompute_ops``) and one ``host_syncs``
  a ``unique``, and nothing at all where the target is kept;
* ``run_many`` fuses values plans with values plans only: a plain plan of
  the same endpoints runs apart and answers as before.

On the card (``card`` marker; skips without one), the same calls at
30,000 x 33,000 rows count as many ``host_syncs`` under ``session.run``
as ``torch.cuda``'s sync debug mode warns of.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import spans
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.recompute import RECOMPUTE_OPS, RECOMPUTE_ROWS
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import QuerySession, RecordValues, prov
from test_torch_spans import SyncOps, _tpcdi_tables, syncs

CPU = "cpu"
B = 64
FETCH = "session.run/recompute.fetch"


def _on(t: Table, device) -> Table:
    return dataclasses.replace(t, data=t.data.to(device), null=t.null.to(device),
                               index=t.index.to(device))


def capture(device, scaled_left=False, **sizes):
    """(index, sink, join output, left input of the join): the trade x
    security join and its filter; with ``scaled_left`` the trades are
    scaled first, so that the join's left input is not kept either."""
    left, right = (_on(t, device) for t in _tpcdi_tables(**sizes))
    idx = ProvenanceIndex("tpcdi", device=device)
    a = track(left, idx, "trade")
    if scaled_left:
        a = a.value_transform("l1", "scale", factor=2.0)
    joined = a.join(track(right, idx, "security"), on="key")
    sink = joined.filter_rows(joined.table.col("l0") > 0).mark_sink()
    return idx, sink.dataset_id, joined.dataset_id, a.dataset_id


def plan(index, q, src, target, rng):
    n = index.datasets[src].n_rows          # the probes' rows: Q1's source, Q2's sink
    b = prov(index).source(src)
    b = b.forward() if q == "q1" else b.backward()
    return b.to(target).rows_batch(np.stack([rng.choice(n, 8, replace=False)
                                             for _ in range(B)])).values().plan()


def calls(index, sink, join):
    """(kind, source, target) of each call: Q2 from the sink and Q1 from
    each source to the join output, Q1 to the sink."""
    return [("q2", sink, join), ("q1", "trade", join), ("q1", "security", join),
            ("q1", "trade", sink)]


@pytest.fixture(scope="module")
def worlds():
    return {False: capture(CPU), True: capture(CPU, scaled_left=True)}


CASES = [(scaled, k) for scaled in (False, True) for k in range(4)]


@pytest.mark.parametrize("scaled,k", CASES)
def test_values_host_syncs_match_sync_ops(worlds, scaled, k):
    index, sink, join, _ = worlds[scaled]
    q, src, target = calls(index, sink, join)[k]
    session = QuerySession(index)
    rng = np.random.default_rng(7)
    session.run(plan(index, q, src, target, rng))
    p = plan(index, q, src, target, rng)
    mode = SyncOps()
    with spans.recording() as rec:
        with mode:
            got = session.run(p)
    sm = rec.summary()
    assert sm["loose"] == {}
    assert syncs(sm, "session.run") == mode.n, mode.by_op
    assert isinstance(got, RecordValues) and len(got) == B
    sp = sm["spans"]
    assert sp[FETCH]["count"] == 1
    assert sp["session.run/session.extract"]["counters"][spans.HOST_SYNCS] == 1
    fetch = sp[FETCH]["counters"]
    if target == sink:
        assert fetch == {}                      # a kept target: a gather
        return
    if not scaled:                              # the answer's distinct rows
        assert fetch[RECOMPUTE_ROWS] == len(torch.unique(got.rows))
    # the join re-executed once; the scaled trades too where they are not kept
    assert fetch[RECOMPUTE_OPS] == (2 if scaled else 1)
    # the union's unique; the join's left input's where it is recomputed
    assert fetch[spans.HOST_SYNCS] == (2 if scaled else 1)


def test_values_counts_the_rows_recomputed(worlds):
    index, sink, join, left = worlds[True]
    session = QuerySession(index)
    p = plan(index, "q2", sink, join, np.random.default_rng(3))
    with spans.recording() as rec:
        got = session.run(p)
    fetch = rec.summary()["spans"][FETCH]["counters"]
    rows = torch.unique(got.rows)
    pairs = index.ops[index.producer[join]].info.join_pairs[rows]
    assert fetch[RECOMPUTE_ROWS] == len(rows) + len(torch.unique(pairs[:, 0]))


def test_values_plans_fuse_only_with_values_plans(worlds):
    index, sink, join, _ = worlds[False]
    rng = np.random.default_rng(5)
    v1, v2 = plan(index, "q2", sink, join, rng), plan(index, "q2", sink, join, rng)
    plain = prov(index).source(sink).backward().to(join).rows_batch(v1.rows).plan()
    assert v1.fuse_key() == v2.fuse_key() != plain.fuse_key()
    assert "values" in v1.describe() and "values" not in plain.describe()
    session = QuerySession(index)
    out = session.run_many([v1, plain, v2])
    assert session.counters["fused_groups"] == 1 and session.counters["fused_plans"] == 2
    assert isinstance(out[0], RecordValues) and isinstance(out[2], RecordValues)
    assert isinstance(out[1], list) and all(isinstance(r, torch.Tensor) for r in out[1])
    alone = QuerySession(index)
    for fused, p in ((out[0], v1), (out[2], v2)):
        want = alone.run(p)
        assert fused.offsets == want.offsets and torch.equal(fused.rows, want.rows)
        assert torch.equal(fused.data.view(torch.int32), want.data.view(torch.int32))
    for g, w in zip(out[1], alone.run(plain)):
        assert torch.equal(g, w)
    for g, w in zip(out[1], out[0]):
        assert torch.equal(g, w.rows)


# -- on the card ------------------------------------------------------------------
@pytest.mark.card
@pytest.mark.parametrize("scaled", [False, True])
def test_values_host_syncs_match_debug_mode_on_the_card(scaled):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    index, sink, join, _ = capture(dev, scaled_left=scaled, n_left=30_000, n_right=33_000)
    session = QuerySession(index)
    rng = np.random.default_rng(11)
    for q, src, target in calls(index, sink, join):
        session.run(plan(index, q, src, target, rng))          # warm
        p = plan(index, q, src, target, rng)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with spans.recording() as rec, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                session.run(p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        warned = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
        counted = syncs(rec.summary(), "session.run")
        print(f"{q} {src}->{target}: counted {counted}, warned {len(warned)}")
        assert counted == len(warned), warned
