"""Answer extraction: ``repro_torch.core.query.rows_per_probe``.

The function turns a ``(B, n)`` bool mask stack into B row lists with one
host read.  It is held to the per-probe ``torch.nonzero`` it replaced:
the same values, int64, contiguous, ascending, on the stack's device, and
one ``host_syncs`` a batch.  Over Q1/Q2 (with and without ``how``),
Q10 and Q11 plans on Compas and on a cut TPC-DI join, on both routes and
with the fused walk off and on, every mask stack a session extracts gives
the per-probe ``nonzero``'s answers, and the session's answers equal
those of a session that extracts with the per-probe ``nonzero``.

On the card (``card`` marker; skips without one), a B = 64 stack at
TPC-DI's 2,411,006 rows makes exactly one synchronising call under
``torch.cuda``'s sync debug mode.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import query as Q
from repro_torch.core import spans
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as U
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import QuerySession, prov

CPU = "cpu"


def per_probe_nonzero(mask_stack):
    return [torch.nonzero(m).reshape(-1) for m in mask_stack]


def _stack(B, n, seed):
    """Random densities per probe, with an empty probe and an all-true one
    where the batch has room."""
    g = torch.Generator().manual_seed(seed)
    dens = torch.rand(B, 1, generator=g) ** 3
    m = torch.rand(B, n, generator=g) < dens
    if B >= 2:
        m[0] = False
        m[1] = True
    return m


def _same(got, want, device):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device == torch.device(device)
        assert g.is_contiguous() and g.dim() == 1
        assert torch.equal(g, w)
        assert bool((g[1:] > g[:-1]).all())


@pytest.mark.parametrize("n", [0, 1, 510, 7214, 100_003])
@pytest.mark.parametrize("B", [0, 1, 2, 64])
def test_rows_per_probe_matches_nonzero(B, n):
    m = _stack(B, n, seed=B * 7 + n)
    with spans.recording() as rec:
        with spans.span("x"):
            got = Q.rows_per_probe(m)
    _same(got, per_probe_nonzero(m), CPU)
    counters = rec.summary()["spans"]["x"]["counters"]
    assert counters.get(spans.HOST_SYNCS, 0) == (1 if B else 0)


def test_rows_per_probe_takes_a_strided_stack():
    for m in (_stack(9, 700, seed=3)[::2, 5:], _stack(600, 9, seed=4).t()):
        _same(Q.rows_per_probe(m), per_probe_nonzero(m), CPU)


# -- the session's extraction -------------------------------------------------
B = 16


def _tpcdi(seed=1, n_left=3000, n_right=3300):
    """TPC-DI's trade x security join at a cut size, then ``l0 > 0``."""
    rng = np.random.default_rng(seed)
    left = {"key": rng.integers(0, n_right, n_left).astype(np.float32),
            **{f"l{j}": rng.normal(size=n_left).astype(np.float32) for j in range(20)}}
    right = {"key": np.arange(n_right, dtype=np.float32),
             **{f"r{j}": rng.normal(size=n_right).astype(np.float32) for j in range(14)}}
    idx = ProvenanceIndex("tpcdi", device=CPU)
    joined = track(Table.from_columns(left, device=CPU), idx, "trade").join(
        track(Table.from_columns(right, device=CPU), idx, "security"), on="key")
    sink = joined.filter_rows(joined.table.col("l0") > 0).mark_sink()
    return idx, joined.dataset_id, sink.dataset_id


@pytest.fixture(scope="module")
def indexes():
    compas = ProvenanceIndex("compas", device=CPU)
    c_sink = U.run_compas(compas, U.make_compas(device=CPU)).dataset_id
    tpcdi, t_join, t_sink = _tpcdi()
    # (index, source, the other input, a middle dataset, sink)
    return {"compas": (compas, "compas_src", "compas_src", "filter#1", c_sink),
            "tpcdi": (tpcdi, "trade", "security", t_join, t_sink)}


def _plan(index, q, src, other, mid, sink, rng):
    def probes(ds):
        n = index.datasets[ds].n_rows
        return np.stack([rng.choice(n, 8, replace=False) for _ in range(B)])

    b = prov(index)
    if q.startswith("q1"):
        b = b.source(src).rows_batch(probes(src)).forward().to(sink)
    elif q.startswith("q2"):
        b = b.source(sink).rows_batch(probes(sink)).backward().to(src)
    elif q == "q10":
        b = b.source(src).rows_batch(probes(src)).co_contributory(other)
    else:
        b = b.source(sink).rows_batch(probes(sink)).co_dependency(src, mid)
    if q.endswith("how"):
        b = b.how()
    return b.plan()


@pytest.mark.parametrize("fused_walk", [None, True])
@pytest.mark.parametrize("use_hopcache", [True, False])
@pytest.mark.parametrize("q", ["q1", "q2", "q1how", "q2how", "q10", "q11"])
@pytest.mark.parametrize("config", ["compas", "tpcdi"])
def test_session_answers_match_per_probe_nonzero(indexes, monkeypatch, config, q,
                                                 use_hopcache, fused_walk):
    index, src, other, mid, sink = indexes[config]
    plan = _plan(index, q, src, other, mid, sink, np.random.default_rng(11))

    with monkeypatch.context() as mp:
        mp.setattr(Q, "rows_per_probe", per_probe_nonzero)
        want = QuerySession(index, use_hopcache=use_hopcache, fused_walk=fused_walk).run(plan)

    calls = []
    real = Q.rows_per_probe

    def recorded(mask_stack):
        out = real(mask_stack)
        calls.append((mask_stack.clone(), out))
        return out

    monkeypatch.setattr(Q, "rows_per_probe", recorded)
    got = QuerySession(index, use_hopcache=use_hopcache, fused_walk=fused_walk).run(plan)

    assert calls
    for stack, out in calls:
        _same(out, per_probe_nonzero(stack), CPU)
    assert len(got) == len(want) == B
    if q.endswith("how"):
        assert [h for _, h in got] == [h for _, h in want]
        got, want = [r for r, _ in got], [r for r, _ in want]
    _same(got, want, CPU)
    assert sum(len(r) for r in got) > 0


# -- on the card ------------------------------------------------------------------
@pytest.mark.card
def test_one_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator("cuda").manual_seed(0)
    m = torch.rand(64, 2_411_006, device="cuda", generator=g) < 8 / 2_411_006 * 4
    m[1] = True
    want = per_probe_nonzero(m)
    Q.rows_per_probe(m)                     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = Q.rows_per_probe(m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    print(f"syncs under the debug mode: {len(syncs)}: {syncs}")
    assert len(syncs) == 1, syncs
    _same(got, want, "cuda:0")
