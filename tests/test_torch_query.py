"""Record-level queries in the port against the JAX package, byte for byte.

Q1/Q2 (single and batched), Q5/Q6 hop traces, Q9, Q10 and Q11 go through
``repro_torch.provenance.prov(index)`` and through ``repro``'s builder with
a walk-only session, on pipelines replayed from ``pipegen.random_specs``,
on the diamond (where the fused walk must decline) and on the German use
case.  Datasets are aligned by op position (each package numbers its own
dataset ids).  The port runs on the CPU, where the fused walk's kernel
entry takes its plain version.
"""
import numpy as np
import pytest
import torch

import pipegen
from repro.core.hopcache import ComposedIndex
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import usecases as RU
from repro.provenance import QuerySession as RSession
from repro.provenance import prov as rprov
from repro_torch.core import query as TQ
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as TU
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.kernels import ops as TK
from repro_torch.provenance import QuerySession, prov
from test_torch_capture import build_merged

CPU = "cpu"


def r_walk(idx) -> RSession:
    return RSession(idx, ComposedIndex(idx), use_hopcache=False, fused_walk=False)


def id_map(r_idx, t_idx) -> dict:
    """repro dataset id -> port dataset id, aligned by op position."""
    m = {d: d for d in r_idx.sources() if d in t_idx.datasets}
    for ro, to in zip(r_idx.ops, t_idx.ops):
        m[ro.output_id] = to.output_id
        m.update(zip(ro.input_ids, to.input_ids))
    return m


def same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


def same_how(got, want, ids):
    assert len(got) == len(want)
    for (g, gh), (w, wh) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
        assert [(h.op_id, h.op_name, h.category, h.src_dataset, h.dst_dataset, h.n_records)
                for h in gh] == \
            [(h.op_id, h.op_name, h.category, ids[h.src_dataset], ids[h.dst_dataset],
              h.n_records) for h in wh]


def check_all_queries(r_idx, t_idx, r_src, r_sink, rng):
    ids = id_map(r_idx, t_idx)
    t_src, t_sink = ids[r_src], ids[r_sink]
    n_src, n_dst = r_idx.datasets[r_src].n_rows, r_idx.datasets[r_sink].n_rows
    fwd = pipegen.row_probes(rng, n_src)
    bwd = pipegen.row_probes(rng, n_dst)
    rs = r_walk(r_idx)
    sessions = [QuerySession(t_idx, fused_walk=True), QuerySession(t_idx, fused_walk=False)]
    for ts in sessions:
        # Q1/Q2, batched and single
        same_records(prov(t_idx).source(t_src).rows_batch(fwd).forward().to(t_sink).run(ts),
                     rprov(r_idx).source(r_src).rows_batch(fwd).forward().to(r_sink).run(rs))
        same_records(prov(t_idx).source(t_sink).rows_batch(bwd).backward().to(t_src).run(ts),
                     rprov(r_idx).source(r_sink).rows_batch(bwd).backward().to(r_src).run(rs))
        for p in fwd:
            same_records([prov(t_idx).source(t_src).rows(p).forward().to(t_sink).run(ts)],
                         [rprov(r_idx).source(r_src).rows(p).forward().to(r_sink).run(rs)])
        for p in bwd:
            same_records([prov(t_idx).source(t_sink).rows(p).backward().to(t_src).run(ts)],
                         [rprov(r_idx).source(r_sink).rows(p).backward().to(r_src).run(rs)])
    # Q5/Q6 hop traces
    same_how(prov(t_idx).source(t_src).rows_batch(fwd).forward().to(t_sink).how().run(),
             rprov(r_idx).source(r_src).rows_batch(fwd).forward().to(r_sink).how().run(rs), ids)
    same_how(prov(t_idx).source(t_sink).rows_batch(bwd).backward().to(t_src).how().run(),
             rprov(r_idx).source(r_sink).rows_batch(bwd).backward().to(r_src).how().run(rs), ids)
    # Q9
    t9 = prov(t_idx).source(t_sink).transformations().run()
    r9 = rprov(r_idx).source(r_sink).transformations().run(rs)
    assert [(r["op_id"], r["op"], r["category"], r["contextual"], r["output"]) for r in t9] == \
        [(r["op_id"], r["op"], r["category"], r["contextual"], ids[r["output"]]) for r in r9]
    # Q10: the second input of each binary op (or the first derived dataset)
    partners = [op.input_ids[1] for op in r_idx.ops if len(op.input_ids) == 2] \
        or [r_idx.ops[0].output_id]
    for d2 in partners:
        same_records(
            prov(t_idx).source(t_src).rows_batch(fwd).co_contributory(ids[d2]).run(),
            rprov(r_idx).source(r_src).rows_batch(fwd).co_contributory(d2).run(rs))
    # Q11: sink rows -> source ancestors -> every derived dataset
    for ro in r_idx.ops[:3]:
        same_records(
            prov(t_idx).source(t_sink).rows_batch(bwd).co_dependency(t_src, ids[ro.output_id]).run(),
            rprov(r_idx).source(r_sink).rows_batch(bwd).co_dependency(r_src, ro.output_id).run(rs))
    return sessions[0].counters["fused_walk"]


@pytest.mark.parametrize("seed", range(8))
def test_pipegen_queries_match_reference(seed):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    check_all_queries(r_idx, t_idx, "src", r_ids[-1], np.random.default_rng(seed))


def test_fused_walk_routes_linear_chains():
    """Over the replayed pipelines the audit accepts some chains (and then
    the kernel entry is dispatched) and every fused answer equals the walk."""
    fused = 0
    for seed in range(8):
        base, specs = pipegen.random_specs(seed)
        t_idx, ids = build_merged(base, specs)
        rng = np.random.default_rng(seed)
        rows = torch.from_numpy(rng.random((4, t_idx.datasets["src"].n_rows)) < 0.3)
        TK.reset_launch_counts()
        got = TQ.fused_walk_record_masks_batch(t_idx, "src", ids[-1], rows, "fwd")
        want = TQ.forward_record_masks_batch(t_idx, "src", rows)[ids[-1]]
        if got is not None:
            fused += 1
            assert TK.launch_counts() == {"batched_walk": 1}
            assert torch.equal(got, want)
        rows_d = torch.from_numpy(rng.random((4, t_idx.datasets[ids[-1]].n_rows)) < 0.3)
        got = TQ.fused_walk_record_masks_batch(t_idx, ids[-1], "src", rows_d, "bwd")
        if got is not None:
            assert torch.equal(got, TQ.backward_record_masks_batch(t_idx, ids[-1], rows_d)["src"])
    assert fused > 0
    TK.reset_launch_counts()


def _diamond(seed=0):
    rng = np.random.default_rng(seed)
    idx = ProvenanceIndex(f"diamond{seed}", device=CPU)
    n = int(rng.integers(8, 20))
    t = Table.from_columns({"k": np.arange(n, dtype=np.float32),
                            "x": rng.normal(size=n).astype(np.float32)}, device=CPU)
    s = track(t, idx, "src")
    a = s.filter_rows(rng.random(n) < 0.75)
    b = s.value_transform("x", "scale", factor=2.0)
    return idx, a.join(b, on="k", how="inner").mark_sink().dataset_id


def test_diamond_declines_fusion_and_walk_answers():
    r_idx, r_sink = pipegen.diamond_pipeline(0)
    t_idx, t_sink = _diamond(0)
    n = t_idx.datasets["src"].n_rows
    rows = torch.zeros((2, n), dtype=torch.bool)
    rows[:, 0] = True
    assert TQ.fused_walk_record_masks_batch(t_idx, "src", t_sink, rows, "fwd") is None
    session = QuerySession(t_idx, fused_walk=True)
    prov(t_idx).source("src").rows_batch([[0], [1, 2]]).forward().to(t_sink).run(session)
    assert session.counters["fused_walk"] == 0
    check_all_queries(r_idx, t_idx, "src", r_sink, np.random.default_rng(0))


def test_fused_walk_identity_pair_returns_the_seed():
    t_idx, _ = _diamond(1)
    rows = torch.from_numpy(np.random.default_rng(1).random((3, t_idx.datasets["src"].n_rows)) < 0.4)
    assert torch.equal(TQ.fused_walk_record_masks_batch(t_idx, "src", "src", rows), rows)


def test_german_queries_match_reference():
    r_idx = RIndex("german")
    r_sink = RU.run_german(r_idx, RU.make_german()).dataset_id
    t_idx = ProvenanceIndex("german", device=CPU)
    TU.run_german(t_idx, TU.make_german(device=CPU))
    TK.reset_launch_counts()
    fused = check_all_queries(r_idx, t_idx, "german_src", r_sink, np.random.default_rng(11))
    assert fused > 0 and TK.launch_counts()["batched_walk"] >= fused


def test_default_session_resolves_fused_walk_by_device():
    t_idx, _ = _diamond(2)
    assert t_idx.session().fused_walk is None
    assert t_idx.session()._fused_walk_on() is False     # a CPU index walks by default


def test_run_many_fuses_and_keeps_submission_order():
    base, specs = pipegen.random_specs(1)
    t_idx, ids = build_merged(base, specs)
    session = QuerySession(t_idx)
    n_src, n_dst = t_idx.datasets["src"].n_rows, t_idx.datasets[ids[-1]].n_rows
    plans = [
        prov(t_idx).source("src").rows([0, 1]).forward().to(ids[-1]),
        prov(t_idx).source(ids[-1]).rows([0]).backward().to("src"),
        prov(t_idx).source("src").rows_batch([[2], [n_src - 1]]).forward().to(ids[-1]),
        prov(t_idx).source(ids[-1]).transformations(),
        prov(t_idx).source(ids[-1]).rows([n_dst - 1]).backward().to("src"),
    ]
    got = session.run_many(plans)
    want = [QuerySession(t_idx).run(p.plan()) for p in plans]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))
    assert got[3] == want[3] and torch.equal(got[4], want[4])
    assert session.counters["fused_groups"] == 2 and session.counters["fused_plans"] == 4


def test_unported_strategies_raise():
    t_idx, sink = _diamond(3)
    with pytest.raises(NotImplementedError, match="A5"):
        QuerySession(t_idx, use_hopcache=True)
    with pytest.raises(NotImplementedError, match="A5"):
        prov(t_idx).source("src").rows([0]).attrs([0]).forward().to(sink).run()


def test_builder_validates_probes():
    t_idx, sink = _diamond(4)
    n = t_idx.datasets["src"].n_rows
    p = prov(t_idx).source("src").rows(np.arange(n) < 3).forward().to(sink).plan()
    assert p.rows.shape == (1, n) and int(p.rows.sum()) == 3 and p.rows.device.type == "cpu"
    assert prov(t_idx).source("src").rows_batch([]).forward().to(sink).plan().n_probes == 0
    with pytest.raises(ValueError):
        prov(t_idx).source("src").rows(np.zeros((2, n), bool)).forward().to(sink).plan()
    with pytest.raises(KeyError):
        prov(t_idx).source("nope")
