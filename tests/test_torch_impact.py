"""Impact analysis in the port against the JAX package.

Every world of ``tests/test_impact.py`` that needs no ``ServeEngine`` is
built into both packages (the port's twins of ``pipegen.random_pipeline``,
``pipegen.build_federated`` and ``test_impact._whatif_pipeline`` live here
or in ``test_torch_federation``) and both run ``erasure_plan``,
``apply_invalidations`` and ``whatif_replay``.  Exact: the plan's impacts
(refs, order, rows, row counts, materialization, sinks, estimates), the
rebuild set, the invalidations (kind, scope, pair, residency), the counts
``apply_invalidations`` drops, and what-if's rows.  What-if values agree to
float32 rounding (rtol = atol = 1e-5, as capture: means and deviations sum
in another order).  Dataset ids are mapped by op position.
"""
import re

import numpy as np
import pytest
import torch

import pipegen
import test_impact as RT
from repro.core import costmodel as RCM
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as rtrack
from repro.provenance import FederatedSession as RFed
from repro.provenance import ProvCatalog as RCatalog
from repro.provenance import apply_invalidations as r_apply
from repro.provenance import erasure_plan as r_erasure
from repro.provenance import whatif_replay as r_whatif
from repro_torch.core import costmodel as TCM
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.query import rows_per_probe
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import (
    FederatedSession,
    FederationError,
    ProvCatalog,
    RecomputePlan,
    apply_invalidations,
    erasure_plan,
    prov,
    whatif_replay,
)
from repro_torch.provenance.catalog import qualify
from test_torch_capture import build_merged
from test_torch_federation import Ids, build_federated, cross_boundary_diamond
from test_torch_query import id_map
from torch_pipegen import random_pipeline

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = list(range(6))


@pytest.fixture(autouse=True)
def default_constants(monkeypatch, tmp_path):
    """Both cost models on their (equal) defaults, so estimates compare."""
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "absent_repro.json"))
    RCM.reset_constants()
    TCM.reset_constants()
    yield
    RCM.reset_constants()
    TCM.reset_constants()


def _pipelines(seed):
    r_idx, r_sink, rng = pipegen.random_pipeline(seed)
    t_idx, t_sink, _ = random_pipeline(seed)
    ids = id_map(r_idx, t_idx)
    assert ids[r_sink] == t_sink
    return r_idx, t_idx, r_sink, ids, rng


def _fmap(ids):
    """repro ref -> port ref, also inside a longer string: ``ids`` is an
    :class:`Ids` (a catalog) or an ``id_map`` dict (one index)."""
    if isinstance(ids, Ids):
        return ids.text
    pat = re.compile("|".join(re.escape(k) for k in sorted(ids, key=len, reverse=True)))
    return lambda s: pat.sub(lambda m: ids[m.group(0)], s)


def same_plan(t_plan: RecomputePlan, r_plan, ids):
    """Impacts in order (refs, rows, counts, flags, estimates), sources,
    invalidations, rebuild set and total estimate equal ``repro``'s."""
    f = _fmap(ids)
    assert isinstance(t_plan, RecomputePlan)
    assert t_plan.affected == tuple(f(r) for r in r_plan.affected)
    for ti, ri in zip(t_plan.impacts, r_plan.impacts):
        assert ti.rows.dtype == torch.int64
        np.testing.assert_array_equal(ti.rows.numpy(), ri.rows)
        assert (ti.n_rows, ti.materialized, ti.is_sink, ti.n_affected) == \
            (ri.n_rows, ri.materialized, ri.is_sink, ri.n_affected)
        assert ti.est_ns == ri.est_ns
    assert [(r, rows.tolist()) for r, rows in t_plan.sources] == \
        [(f(r), rows.tolist()) for r, rows in r_plan.sources]
    assert [(i.scope, i.kind, i.src, i.dst, i.residency) for i in t_plan.invalidations] == \
        [(i.scope, i.kind, f(i.src), f(i.dst), i.residency) for i in r_plan.invalidations]
    assert t_plan.rebuild == tuple(f(r) for r in r_plan.rebuild)
    assert t_plan.est_total_ns == r_plan.est_total_ns
    assert t_plan.describe().splitlines() == [f(x) for x in r_plan.describe().splitlines()]
    for ti in t_plan.impacts:
        assert t_plan.impact(ti.ref) is ti
    assert t_plan.impact("nowhere") is None


# ---------------------------------------------------------------------------
# Erasure closure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_erasure_closure_matches_per_row_queries_and_reference(seed):
    r_idx, t_idx, r_sink, ids, rng = _pipelines(seed)
    n = t_idx.datasets["src"].n_rows
    rows = sorted(set(rng.integers(0, n, size=4).tolist()))
    plan = erasure_plan(t_idx, "src", rows)
    same_plan(plan, r_erasure(r_idx, "src", rows), ids)
    got = {i.ref: i.rows for i in plan.impacts}
    for ds in t_idx.datasets:
        expected = torch.zeros(t_idx.datasets[ds].n_rows, dtype=torch.bool)
        for r in rows:
            expected[prov(t_idx).source("src").rows([r]).forward().to(ds).run()] = True
        if bool(expected.any()):
            assert torch.equal(got[ds], torch.nonzero(expected).reshape(-1)), ds
        else:
            assert ds not in got, ds
    assert all(i.n_affected > 0 for i in plan.impacts)
    assert plan.impacts[0].ref == "src" and plan.impacts[0].rows.tolist() == rows


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_ordered_classified_and_estimated_like_reference(seed):
    """Registration order, classification, rebuild set, and estimates that
    equal the port's own cost model (``composed_estimate`` +
    ``relation_probe_cost``) — and ``repro``'s, whose routing defaults the
    port keeps."""
    r_idx, t_idx, _, ids, _ = _pipelines(seed)
    plan = erasure_plan(t_idx, "src", np.array([1, 0, 1]))
    same_plan(plan, r_erasure(r_idx, "src", [0, 1]), ids)
    assert list(plan.affected) == [d for d in t_idx.datasets if d in set(plan.affected)]
    assert "src" not in plan.rebuild
    cm = t_idx.session().costmodel
    for i in plan.impacts:
        rec = t_idx.datasets[i.ref]
        assert (i.materialized, i.is_sink, i.n_rows) == (rec.materialized, rec.is_sink, rec.n_rows)
        if i.ref in plan.rebuild:
            rel, ns = cm.composed_estimate("src", i.ref)
            want = 0.0 if rel is None else float(ns) + TCM.relation_probe_cost(rel, 1, 2.0)
            assert i.est_ns == want
        else:
            assert i.est_ns == 0.0
    assert plan.est_total_ns == sum(i.est_ns for i in plan.impacts)


def test_erasure_rejects_bad_rows_and_unknown_source():
    t_idx, _, _ = random_pipeline(0)
    with pytest.raises(KeyError):
        erasure_plan(t_idx, "nope", [0])
    with pytest.raises(IndexError):
        erasure_plan(t_idx, "src", [t_idx.datasets["src"].n_rows + 5])
    with pytest.raises(IndexError):
        erasure_plan(t_idx, "src", [-1])
    empty = erasure_plan(t_idx, "src", [])
    assert empty.impacts == () and empty.est_total_ns == 0.0


# ---------------------------------------------------------------------------
# Cache invalidation
# ---------------------------------------------------------------------------
def test_invalidation_drops_stale_entries_and_is_idempotent():
    r_idx, t_idx, r_sink, ids, _ = _pipelines(3)
    sink = ids[r_sink]
    comp, r_comp = t_idx.composed(), r_idx.composed()
    comp.relation("src", sink)
    r_comp.relation("src", r_sink)
    assert comp.stats()["entries"] == r_comp.stats()["entries"] > 0
    plan, r_plan = erasure_plan(t_idx, "src", [0]), r_erasure(r_idx, "src", [0])
    same_plan(plan, r_plan, ids)
    assert {i.kind for i in plan.invalidations} == {"composed"}
    assert apply_invalidations(t_idx, plan) == r_apply(r_idx, r_plan) == len(plan.invalidations)
    assert comp.stats()["entries"] == 0
    assert apply_invalidations(t_idx, plan) == r_apply(r_idx, r_plan) == 0
    plan2 = erasure_plan(t_idx, "src", [0])
    assert not plan2.invalidations and apply_invalidations(t_idx, plan2) == 0
    seed = torch.zeros((1, t_idx.datasets["src"].n_rows), dtype=torch.bool)
    seed[0, 0] = True
    hit = rows_per_probe(comp.probe_forward(seed, "src", sink))[0]
    assert torch.equal(hit, prov(t_idx).source("src").rows([0]).forward().to(sink).run())


def test_invalidation_deletes_spilled_payloads(tmp_path):
    r_idx, t_idx, r_sink, ids, _ = _pipelines(3)
    comp = t_idx.composed(memory_budget_bytes=512, spill=str(tmp_path / "port"),
                          backend="bitplane")
    r_comp = r_idx.composed(memory_budget_bytes=512, spill=str(tmp_path / "repro"),
                            backend="bitplane")
    comp.relation("src", ids[r_sink])
    r_comp.relation("src", r_sink)
    assert comp.stats()["spilled_entries"] == r_comp.stats()["spilled_entries"] > 0
    n_payloads = comp._spill_store.stats()["entries"]
    plan, r_plan = erasure_plan(t_idx, "src", [0]), r_erasure(r_idx, "src", [0])
    same_plan(plan, r_plan, ids)
    assert "spilled" in {i.residency for i in plan.invalidations}
    assert apply_invalidations(t_idx, plan) == r_apply(r_idx, r_plan)
    assert comp.stats()["entries"] == 0 and comp.stats()["spilled_entries"] == 0
    assert comp._spill_store.stats()["entries"] < n_payloads
    assert comp._spill_store.stats()["entries"] == r_comp._spill_store.stats()["entries"]


def _spare_world(pkg):
    if pkg == "repro":
        Index, T, trk, kw = RIndex, RTable, rtrack, {}
    else:
        Index, T, trk, kw = ProvenanceIndex, Table, track, {"device": CPU}
    idx = Index("inv-spare", **kw)
    rng = np.random.default_rng(0)
    a = trk(T.from_columns({"k": np.arange(10, dtype=np.float32),
                            "x": rng.normal(size=10).astype(np.float32)}, **kw), idx, "a")
    b = trk(T.from_columns({"k": np.arange(10, dtype=np.float32),
                            "z": rng.normal(size=10).astype(np.float32)}, **kw), idx, "b")
    b2 = b.value_transform("z", "scale", factor=3.0)
    j = a.join(b2, on="k", how="inner").mark_sink()
    idx.composed().relation("a", j.dataset_id)
    idx.composed().relation("b", b2.dataset_id)
    return idx, b2.dataset_id, j.dataset_id


def test_invalidation_spares_unrelated_entries():
    t_idx, b2, j = _spare_world("port")
    r_idx, r_b2, r_j = _spare_world("repro")
    plan, r_plan = erasure_plan(t_idx, "a", [0, 1]), r_erasure(r_idx, "a", [0, 1])
    same_plan(plan, r_plan, id_map(r_idx, t_idx))
    assert ("b", b2) not in {(i.src, i.dst) for i in plan.invalidations}
    assert apply_invalidations(t_idx, plan) == r_apply(r_idx, r_plan)
    assert t_idx.composed().residency("b", b2) == "ram"
    assert t_idx.composed().residency("a", j) is None


# ---------------------------------------------------------------------------
# What-if replay
# ---------------------------------------------------------------------------
def _whatif_pipeline(base, keep, ref1, ref2, name):
    """The port's twin of ``test_impact._whatif_pipeline`` (tables given as
    numpy column dicts)."""
    idx = ProvenanceIndex(name, device=CPU)
    cur = track(Table.from_columns(base, device=CPU), idx, "src")
    cur = cur.value_transform("x", "scale", factor=2.0)
    cur = cur.filter_rows(torch.from_numpy(keep))
    cur = cur.join(track(Table.from_columns(ref1, device=CPU), idx), on="k", how="outer")
    cur = cur.oversample(frac=0.4, seed=5, noise=0.1)
    cur = cur.append(track(Table.from_columns(ref2, device=CPU), idx))
    cur.mark_sink()
    return idx, cur.dataset_id, cur.table


def _rows_close(a_data, a_null, b_data, b_null):
    np.testing.assert_array_equal(a_null, b_null)
    ok = ~a_null
    np.testing.assert_allclose(a_data[ok], b_data[ok], **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_whatif_replay_matches_full_rerun_and_reference(seed):
    rng = np.random.default_rng(seed)
    n, K = 30, 8
    base = {"k": rng.integers(0, K, n).astype(np.float32),
            "x": rng.normal(size=n).astype(np.float32)}
    keep = rng.random(n) < 0.7
    if not keep.any():
        keep[0] = True
    ref1 = {"k": np.arange(K, dtype=np.float32), "z": rng.normal(size=K).astype(np.float32)}
    ref2 = {"x": rng.normal(size=4).astype(np.float32), "z": rng.normal(size=4).astype(np.float32)}
    t_idx, sink, orig = _whatif_pipeline(base, keep, ref1, ref2, f"wi{seed}")
    r_idx, r_sink, _ = RT._whatif_pipeline(RTable.from_columns(base), keep,
                                           RTable.from_columns(ref1), RTable.from_columns(ref2),
                                           f"wi{seed}")
    rows = sorted(set(rng.integers(0, n, size=3).tolist()))
    vals = rng.normal(size=len(rows)).astype(np.float32) * 10
    res = whatif_replay(t_idx, "src", rows, {"x": vals}, sink)
    r_res = r_whatif(r_idx, "src", rows, {"x": vals}, r_sink)
    assert res.source_rows.tolist() == r_res.source_rows.tolist() == rows
    np.testing.assert_array_equal(res.sink_rows.numpy(), r_res.sink_rows)
    for t_tab, r_tab in ((res.before, r_res.before), (res.after, r_res.after)):
        assert t_tab.columns == r_tab.columns
        _rows_close(t_tab.data.numpy(), t_tab.null.numpy(), r_tab.data, r_tab.null)
    np.testing.assert_array_equal(res.changed.numpy(), r_res.changed)
    deltas, r_deltas = res.row_deltas(), r_res.row_deltas()
    assert [sorted(d) for d in deltas] == [sorted(d) for d in r_deltas]
    for d, rd in zip(deltas, r_deltas):
        for c in d:
            np.testing.assert_allclose(d[c], rd[c], **TOL)
    # ground truth in the port: the same frozen pipeline over the patched base
    patched = dict(base, x=base["x"].copy())
    patched["x"][np.asarray(rows)] = vals
    _, _, full = _whatif_pipeline(patched, keep, ref1, ref2, f"wi{seed}-rerun")
    sr = res.sink_rows
    _rows_close(res.before.data.numpy(), res.before.null.numpy(),
                orig.data[sr].numpy(), orig.null[sr].numpy())
    _rows_close(res.after.data.numpy(), res.after.null.numpy(),
                full.data[sr].numpy(), full.null[sr].numpy())
    outside = np.setdiff1d(np.arange(orig.n_rows), sr.numpy())
    _rows_close(orig.data[outside].numpy(), orig.null[outside].numpy(),
                full.data[outside].numpy(), full.null[outside].numpy())
    assert len(sr) < orig.n_rows
    assert [bool(d) for d in deltas] == res.changed.tolist()


def test_whatif_restores_recorded_state():
    t_idx, sink, _ = random_pipeline(5)
    r_idx, r_sink, _ = pipegen.random_pipeline(5)
    src_rec = t_idx.datasets["src"]
    tables = {ds: r.table for ds, r in t_idx.datasets.items()}
    saved = {ds: (t.data.clone(), t.null.clone(), t.index.clone())
             for ds, t in tables.items() if t is not None}
    res = whatif_replay(t_idx, "src", [0], {"x": [99.0]}, sink)
    r_res = r_whatif(r_idx, "src", [0], {"x": [99.0]}, r_sink)
    np.testing.assert_array_equal(res.sink_rows.numpy(), r_res.sink_rows)
    for ds, r in t_idx.datasets.items():
        assert r.table is tables[ds]
        if r.table is not None:
            for a, b in zip((r.table.data, r.table.null, r.table.index), saved[ds]):
                assert torch.equal(a, b)
    assert src_rec.table.data[0, src_rec.table.cid("x")] != 99.0
    with pytest.raises(ValueError, match="not materialized"):
        mid = next(d for d, r in t_idx.datasets.items() if r.table is None)
        whatif_replay(t_idx, mid, [0], {"x": [1.0]}, sink)
    with pytest.raises(KeyError):
        whatif_replay(t_idx, "src", [0], {"x": [1.0]}, "nope")


def test_whatif_over_catalog_delegates_within_member():
    base, specs = pipegen.random_specs(2)
    rc, rrefs, rsink = pipegen.build_federated(base, specs, 1)
    tc, trefs, tsink = build_federated(base, specs, 1)
    res = whatif_replay(tc, "serve/ingest", [0], {"x": [50.0]}, tsink)
    r_res = r_whatif(rc, "serve/ingest", [0], {"x": [50.0]}, rsink)
    assert res.source == "serve/ingest" and res.sink == tsink
    np.testing.assert_array_equal(res.sink_rows.numpy(), r_res.sink_rows)
    _rows_close(res.after.data.numpy(), res.after.null.numpy(), r_res.after.data,
                r_res.after.null)
    with pytest.raises(FederationError, match="never leave"):
        whatif_replay(tc, "prep/src", [0], {"x": [1.0]}, tsink)
    prep = tc.members["prep"]._index
    capped = ProvCatalog("capped", device=CPU)
    capped.register("prep", prep.export(split(trefs[1])))
    with pytest.raises(FederationError, match="read-only boundary capability"):
        whatif_replay(capped, "prep/src", [0], {"x": [1.0]}, trefs[1])


def split(ref):
    return ref.split("/", 1)[1]


# ---------------------------------------------------------------------------
# Federated erasure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cut", [1, 2])
def test_federated_erasure_matches_merged_and_reference(seed, cut):
    base, specs = pipegen.random_specs(seed)
    rc, rrefs, rsink = pipegen.build_federated(base, specs, cut)
    tc, trefs, tsink = build_federated(base, specs, cut)
    merged, m_ids = build_merged(base, specs)
    ref_of = dict(zip(m_ids, trefs))
    rows = [0, min(3, len(base["k"]) - 1)]
    fplan = erasure_plan(tc, "prep/src", rows)
    same_plan(fplan, r_erasure(rc, "prep/src", rows), Ids(rc, tc))
    f_by_ref = {i.ref: i.rows for i in fplan.impacts}
    for i in erasure_plan(merged, "src", rows).impacts:
        if i.ref in ref_of:
            assert torch.equal(f_by_ref[ref_of[i.ref]], i.rows), ref_of[i.ref]
    if trefs[cut] in f_by_ref:
        assert torch.equal(f_by_ref["serve/ingest"], f_by_ref[trefs[cut]])
    members = [i.ref.split("/")[0] for i in fplan.impacts]
    assert members == sorted(members, key=["prep", "serve"].index)


@pytest.mark.parametrize("seed", range(3))
def test_federated_erasure_across_two_links(seed):
    """The cross-boundary diamond: the serve member is walked ONCE, seeded
    through both links."""
    _, _, rc, rsink = pipegen.cross_boundary_diamond(seed)
    tc, tsink = cross_boundary_diamond(seed)
    for rows in ([0], [2, 5, 7]):
        same_plan(erasure_plan(tc, "prep/src", rows), r_erasure(rc, "prep/src", rows), Ids(rc, tc))
    assert tc.members["serve"]._index.session().counters["plans"] == \
        rc.members["serve"]._index.session().counters["plans"] == 2


def test_federated_erasure_lists_and_drops_stale_relations(tmp_path):
    """A stitched cross relation and member hop-cache entries (one of them
    spilled) over the route an erasure poisons: the plan lists them,
    ``apply_invalidations`` drops them (the spilled payload deleted from its
    store) and a second apply drops nothing."""
    base, specs = pipegen.random_specs(0)
    rc, rrefs, rsink = pipegen.build_federated(base, specs, 2)
    tc, trefs, tsink = build_federated(base, specs, 2)
    ids = Ids(rc, tc)
    t_prep, r_prep = tc.members["prep"]._index, rc.members["prep"]._index
    t_prep.composed(memory_budget_bytes=256, spill=str(tmp_path / "port"), backend="bitplane")
    r_prep.composed(memory_budget_bytes=256, spill=str(tmp_path / "repro"), backend="bitplane")
    FederatedSession(tc, cross_min_demand=0).run(
        prov(tc).source("prep/src").rows([0]).forward().to(tsink).plan())
    from repro.provenance import prov as rprov
    RFed(rc, cross_min_demand=0).run(
        rprov(rc).source("prep/src").rows([0]).forward().to(rsink).plan())
    for ref in trefs[1:3]:
        t_prep.composed().relation("src", split(ref))
    for ref in rrefs[1:3]:
        r_prep.composed().relation("src", split(ref))
    assert t_prep.composed().stats()["spilled_entries"] > 0
    n_payloads = t_prep.composed()._spill_store.stats()["entries"]
    plan, r_plan = erasure_plan(tc, "prep/src", [0]), r_erasure(rc, "prep/src", [0])
    same_plan(plan, r_plan, ids)
    kinds = {i.kind for i in plan.invalidations}
    assert kinds == {"cross", "composed"}
    assert "spilled" in {i.residency for i in plan.invalidations}
    cross = [i for i in plan.invalidations if i.kind == "cross"]
    assert (cross[0].src, cross[0].dst, cross[0].scope) == ("prep/src", tsink, tc.name)
    dropped = apply_invalidations(tc, plan)
    assert dropped == r_apply(rc, r_plan) == len(plan.invalidations)
    assert ("prep/src", tsink, "fwd") not in tc._cross_store.entries
    assert tc._cross_store.nbytes == rc._cross_store.nbytes == 0
    st = t_prep.composed().stats()
    assert st["entries"] == 0 and st["spilled_entries"] == 0
    assert t_prep.composed()._spill_store.stats()["entries"] < n_payloads
    assert apply_invalidations(tc, plan) == r_apply(rc, r_plan) == 0


def test_federated_erasure_through_boundary_handle():
    def world(pkg):
        if pkg == "repro":
            Index, T, trk, Cat, kw = RIndex, RTable, rtrack, RCatalog, {}
        else:
            Index, T, trk, Cat, kw = ProvenanceIndex, Table, track, ProvCatalog, {"device": CPU}
        rng = np.random.default_rng(0)
        prep = Index("prep-cap", **kw)
        s = trk(T.from_columns({"k": np.arange(12, dtype=np.float32),
                                "x": rng.normal(size=12).astype(np.float32)}, **kw), prep, "raw")
        clean = s.value_transform("x", "scale", factor=2.0)
        clean.mark_sink()
        serve = Index("serve-cap", **kw)
        ing = trk(clean.table, serve, "ingest")
        ing.filter_rows(rng.random(12) < 0.8).mark_sink()
        cat = Cat("cap", **kw)
        cat.register("prep", prep.export(clean.dataset_id)).register("serve", serve)
        cat.link(qualify("prep", clean.dataset_id), "serve/ingest")
        return cat, clean.dataset_id

    tc, clean = world("port")
    rc, _ = world("repro")
    plan, r_plan = erasure_plan(tc, "prep/raw", [0, 1]), r_erasure(rc, "prep/raw", [0, 1])
    same_plan(plan, r_plan, Ids(rc, tc))
    assert qualify("prep", clean) in set(plan.affected) and "serve/ingest" in set(plan.affected)
    assert all(i.scope != "prep" for i in plan.invalidations)
    assert apply_invalidations(tc, plan) == r_apply(rc, r_plan)


def test_erasure_plan_on_unknown_member_raises():
    tc, tsink = cross_boundary_diamond(0)
    with pytest.raises(FederationError, match="unknown index"):
        erasure_plan(tc, "ghost/src", [0])
    with pytest.raises(IndexError):
        erasure_plan(tc, "prep/src", [10 ** 6])
