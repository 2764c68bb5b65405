"""Federation in the port against federation in the JAX package, exactly.

Every replayable world of ``tests/test_federation.py`` is built twice, into
``repro`` and into the port (the port's twins of ``pipegen.build_federated``
and ``pipegen.cross_boundary_diamond`` live here, on
``test_torch_capture.apply_spec``), and every query runs through both
packages' ``prov(catalog)``: record masks and co-queries, cells lists and
how-traces (link hops included) must be equal; so must ``explain()``
segments and strategies, the session counters (``segments``,
``links_crossed``, ``cross_composes``, ``cross_probes``, ``fused_*``),
the cross store's bytes, demand and evictions, and the member stats.
Stitched relations are compared row set by row set (scipy leaves a CSR
row's columns unsorted).  Dataset ids come from each package's own counter,
so ids are mapped member by member, by op position.  The tests of
``test_federation.py`` that need ``ServeEngine`` wait for the serving tier
(ROADMAP A11/A13); the unrelated-link survival they check is replayed here
without it.
"""
import re

import numpy as np
import pytest
import scipy.sparse as rsp
import torch

import pipegen
from repro.core import costmodel as RCM
from repro.core.hopcache import ComposedIndex as RComposed
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.core.provtensor import pack_bitplane as r_pack
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as rtrack
from repro.provenance import FederatedSession as RFed
from repro.provenance import ProvCatalog as RCatalog
from repro.provenance import prov as rprov
from repro.provenance.catalog import Link as RLink
from repro_torch.core import costmodel as TCM
from repro_torch.core.hopcache import ComposedIndex
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import pack_bitplane
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import (
    BoundaryHandle,
    CapabilityError,
    FederatedSession,
    FederationError,
    ProvCatalog,
    QueryPlan,
    prov,
)
from repro_torch.provenance import federation as TF
from repro_torch.provenance import session as TS
from repro_torch.provenance.catalog import Link, qualify, split_ref
from test_torch_capture import apply_spec, build_merged
from test_torch_query import id_map

CPU = "cpu"
SEEDS = list(range(8))


@pytest.fixture(autouse=True)
def default_constants(monkeypatch, tmp_path):
    """Both cost models on their (equal) defaults: the cross-route gate and
    every member's routing must decide alike."""
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "absent_repro.json"))
    RCM.reset_constants()
    TCM.reset_constants()
    yield
    RCM.reset_constants()
    TCM.reset_constants()


# ===========================================================================
# The port's twins of pipegen's federated worlds
# ===========================================================================
def _table(cols):
    return Table.from_columns({c: v.copy() for c, v in cols.items()}, device=CPU)


def build_federated(base, specs, cut):
    """``pipegen.build_federated`` in the port: prep owns ops [0, cut),
    serve owns the rest over a source holding the boundary table, glued by
    an identity link."""
    prep = ProvenanceIndex("prep", device=CPU)
    cur = track(_table(base), prep, "src")
    refs = [qualify("prep", "src")]
    for spec in specs[:cut]:
        cur = apply_spec(cur, spec, prep)
        refs.append(qualify("prep", cur.dataset_id))
    boundary = cur.dataset_id
    serve = ProvenanceIndex("serve", device=CPU)
    scur = track(cur.table, serve, "ingest")
    for spec in specs[cut:]:
        scur = apply_spec(scur, spec, serve)
        refs.append(qualify("serve", scur.dataset_id))
    scur.mark_sink()
    catalog = ProvCatalog(f"fed-cut{cut}", device=CPU)
    catalog.register("prep", prep).register("serve", serve)
    catalog.link(qualify("prep", boundary), "serve/ingest")
    return catalog, refs, qualify("serve", scur.dataset_id)


def cross_boundary_diamond(seed=0):
    """``pipegen.cross_boundary_diamond`` in the port: two links carry two
    branches of one source across the boundary."""
    rng = np.random.default_rng(seed)
    base = {"k": np.arange(12, dtype=np.float32),
            "x": rng.normal(size=12).astype(np.float32)}
    keep = rng.random(12) < 0.75
    if not keep.any():
        keep[0] = True
    prep = ProvenanceIndex("prep", device=CPU)
    ps = track(_table(base), prep, "src")
    pa = ps.filter_rows(torch.from_numpy(keep))
    pb = ps.value_transform("x", "scale", factor=2.0)
    serve = ProvenanceIndex("serve", device=CPU)
    sa = track(pa.table, serve, "branch_a")
    sb = track(pb.table, serve, "branch_b")
    sj = sa.join(sb, on="k", how="inner").mark_sink()
    catalog = ProvCatalog("diamond", device=CPU)
    catalog.register("prep", prep).register("serve", serve)
    catalog.link(qualify("prep", pa.dataset_id), "serve/branch_a")
    catalog.link(qualify("prep", pb.dataset_id), "serve/branch_b")
    return catalog, qualify("serve", sj.dataset_id)


def _worlds(seed, cut):
    base, specs = pipegen.random_specs(seed)
    r = pipegen.build_federated(base, specs, cut)
    t = build_federated(base, specs, cut)
    return r, t


def _cut(seed, offset):
    _, specs = pipegen.random_specs(seed)
    return int(np.random.default_rng(seed + offset).integers(1, len(specs)))


# ===========================================================================
# Comparison helpers
# ===========================================================================
class Ids:
    """repro ref / dataset id -> the port's, member by member (by op
    position), for qualified refs, bare ids and strings that embed them."""

    def __init__(self, r_cat, t_cat):
        self.per = {}
        for name, m in r_cat.members.items():
            r_idx = getattr(m, "_index", None) or m._BoundaryHandle__index
            tm = t_cat.members[name]
            t_idx = getattr(tm, "_index", None) or tm._BoundaryHandle__index
            self.per[name] = id_map(r_idx, t_idx)
        self._all = {}
        for name, m in self.per.items():
            for r, t in m.items():
                self._all[qualify(name, r)] = qualify(name, t)
        for m in self.per.values():
            for r, t in m.items():
                self._all.setdefault(r, t)
        keys = sorted(self._all, key=len, reverse=True)
        self._pat = re.compile("|".join(re.escape(k) for k in keys)) if keys else None

    def ref(self, r_ref):
        return self._all[r_ref]

    def text(self, s):
        if not isinstance(s, str) or self._pat is None:
            return s
        return self._pat.sub(lambda mt: self._all[mt.group(0)], s)

    def deep(self, obj):
        """Map every string (keys and values) of a nested structure."""
        if isinstance(obj, dict):
            return {self.deep(k): self.deep(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.deep(v) for v in obj)
        return self.text(obj)


def same_records(got, want):
    if isinstance(want, np.ndarray):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


def hop_key(h, ids=None):
    f = ids.text if ids is not None else (lambda d: d)
    return (h.op_id, h.op_name, h.category, f(h.src_dataset), f(h.dst_dataset), h.n_records)


def same_hops(got, want, ids):
    assert [hop_key(h) for h in got] == [hop_key(h, ids) for h in want]


def same_counters(r_sess, t_sess):
    assert t_sess.counters == r_sess.counters
    assert t_sess._cross_bytes == r_sess._cross_bytes
    assert len(t_sess._cross) == len(r_sess._cross)
    assert len(t_sess._cross_failed) == len(r_sess._cross_failed)


def same_store(r_sess, t_sess, ids):
    """Entries (keys in LRU order), bytes, demand, failed routes, and each
    stitched relation row set by row set."""
    assert t_sess._cross_bytes == r_sess._cross_bytes
    keys = [tuple(ids.text(k) for k in key) for key in r_sess._cross]
    assert list(t_sess._cross) == keys
    assert t_sess._route_demand == {tuple(ids.text(k) for k in key): v
                                    for key, v in r_sess._route_demand.items()}
    assert t_sess._cross_failed == {tuple(ids.text(k) for k in key)
                                    for key in r_sess._cross_failed}
    for (r_rel, r_sig), (t_rel, t_sig) in zip(r_sess._cross.values(), t_sess._cross.values()):
        assert t_sig == frozenset((ids.text(u), ids.text(d)) for u, d in r_sig)
        same_csr(t_rel, r_rel)


def same_csr(t_rel, r_rel):
    """Same shape, bytes and row sets; int32 indices, float32 ones."""
    assert tuple(t_rel.shape) == r_rel.shape
    assert t_rel.col_indices().dtype == torch.int32 == t_rel.crow_indices().dtype
    assert t_rel.values().dtype == torch.float32
    assert bool((t_rel.values() == 1).all())
    assert TF._CrossStore.rel_nbytes(t_rel) == int(
        r_rel.data.nbytes + r_rel.indices.nbytes + r_rel.indptr.nbytes)
    np.testing.assert_array_equal(t_rel.crow_indices().numpy(), r_rel.indptr)
    crow, col = t_rel.crow_indices().numpy(), t_rel.col_indices().numpy()
    for i in range(r_rel.shape[0]):
        assert sorted(col[crow[i]:crow[i + 1]]) == sorted(
            r_rel.indices[r_rel.indptr[i]:r_rel.indptr[i + 1]]), i


def _row_probes(rng, n):
    return [[], [int(rng.integers(0, n))],
            sorted(set(rng.integers(0, n, size=min(5, n)).tolist()))]


# ===========================================================================
# Record parity: every cut of several pipelines, both packages
# ===========================================================================
@pytest.mark.parametrize("seed", SEEDS)
def test_federated_record_parity_every_cut(seed):
    """Q1 from the source and Q2 from the sink to EVERY dataset on both
    sides, at every cut 1..n-1: answers, session counters and the cross
    store equal ``repro``'s (the default cost gate decides alike)."""
    base, specs = pipegen.random_specs(seed)
    for cut in range(1, len(specs)):
        (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
        ids = Ids(rc, tc)
        assert [ids.ref(r) for r in rrefs] == trefs and ids.ref(rsink) == tsink
        rng = np.random.default_rng(seed + 1000 + cut)
        n_src = tc.datasets[trefs[0]].n_rows
        n_sink = tc.datasets[tsink].n_rows
        for rows in _row_probes(rng, n_src):
            for rr, tr in zip(rrefs, trefs):
                want = rprov(rc).source(rrefs[0]).rows(rows).forward().to(rr).run()
                got = prov(tc).source(trefs[0]).rows(rows).forward().to(tr).run()
                same_records(got, want)
        for rows in _row_probes(rng, n_sink):
            for rr, tr in zip(rrefs, trefs):
                want = rprov(rc).source(rsink).rows(rows).backward().to(rr).run()
                got = prov(tc).source(tsink).rows(rows).backward().to(tr).run()
                same_records(got, want)
        same_counters(rc.session(), tc.session())
        same_store(rc.session(), tc.session(), ids)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_federated_batch_and_co_queries_parity(seed):
    cut = _cut(seed, 2000)
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
    rng = np.random.default_rng(seed + 2000)
    n_sink = tc.datasets[tsink].n_rows
    probes = [[], [0], sorted(set(rng.integers(0, n_sink, 4).tolist())), []]
    same_records(prov(tc).source(tsink).rows_batch(probes).backward().to(trefs[0]).run(),
                 rprov(rc).source(rsink).rows_batch(probes).backward().to(rrefs[0]).run())
    mid_j = max(cut, 1)
    n_mid = tc.datasets[trefs[mid_j]].n_rows
    rows = [int(rng.integers(0, n_mid))]
    same_records(prov(tc).source(trefs[mid_j]).rows(rows).co_dependency(trefs[0], tsink).run(),
                 rprov(rc).source(rrefs[mid_j]).rows(rows).co_dependency(rrefs[0], rsink).run())
    same_records(prov(tc).source(trefs[0]).rows([0]).co_contributory(trefs[1], via=tsink).run(),
                 rprov(rc).source(rrefs[0]).rows([0]).co_contributory(rrefs[1], via=rsink).run())
    same_counters(rc.session(), tc.session())


def test_empty_batch_and_no_path():
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(3, 1)
    assert prov(tc).source(tsink).rows_batch([]).backward().to(trefs[0]).run() == []
    got = prov(tc).source(tsink).rows([0]).forward().to(trefs[0]).run()
    assert got.dtype == torch.int64 and got.numel() == 0
    rprov(rc).source(rsink).rows_batch([]).backward().to(rrefs[0]).run()
    rprov(rc).source(rsink).rows([0]).forward().to(rrefs[0]).run()
    same_counters(rc.session(), tc.session())


# ===========================================================================
# Diamond across the boundary; alignment stitching
# ===========================================================================
@pytest.mark.parametrize("seed", range(4))
def test_cross_boundary_diamond_parity(seed):
    _, _, rc, rsink = pipegen.cross_boundary_diamond(seed)
    tc, tsink = cross_boundary_diamond(seed)
    n_src = tc.datasets["prep/src"].n_rows
    n_sink = tc.datasets[tsink].n_rows
    for rows in ([], [0], [2, 7], list(range(n_src))):
        same_records(prov(tc).source("prep/src").rows(rows).forward().to(tsink).run(),
                     rprov(rc).source("prep/src").rows(rows).forward().to(rsink).run())
    probes = [[i] for i in range(n_sink)]
    same_records(prov(tc).source(tsink).rows_batch(probes).backward().to("prep/src").run(),
                 rprov(rc).source(rsink).rows_batch(probes).backward().to("prep/src").run())
    same_counters(rc.session(), tc.session())
    assert tc.session().counters["links_crossed"] >= 2


def _aligned(pkg, alignment=(5, 2, 2, -1)):
    """prep/raw (6 rows) -> serve/req (4 rows) through ``alignment``."""
    if pkg == "repro":
        Index, T, trk, Cat = RIndex, RTable, rtrack, RCatalog
        kw, cat_kw = {}, {}
    else:
        Index, T, trk, Cat = ProvenanceIndex, Table, track, ProvCatalog
        kw, cat_kw = {"device": CPU}, {"device": CPU}
    prep = Index("prep", **kw)
    trk(T.from_columns({"k": np.arange(6, dtype=np.float32),
                        "x": np.ones(6, np.float32)}, **kw), prep, "raw").mark_sink()
    serve = Index("serve", **kw)
    s = trk(T.from_columns({"k": np.zeros(4, np.float32),
                            "x": np.ones(4, np.float32)}, **kw), serve, "req")
    out = s.value_transform("x", "scale", factor=3.0).mark_sink()
    catalog = Cat("aligned", **cat_kw)
    catalog.register("prep", prep).register("serve", serve)
    catalog.link("prep/raw", "serve/req", alignment=list(alignment))
    return catalog, qualify("serve", out.dataset_id)


@pytest.mark.parametrize("demand", [None, 0])
def test_alignment_stitch_duplicates_and_unlinked(demand):
    """Duplicates OR-accumulate backward, unlinked rows vanish — on the
    segment path and (``cross_min_demand=0``) the stitched relation."""
    rc, rref = _aligned("repro")
    tc, tref = _aligned("port")
    rs = RFed(rc) if demand is None else RFed(rc, cross_min_demand=demand)
    ts = FederatedSession(tc) if demand is None else FederatedSession(tc, cross_min_demand=demand)
    got = ts.run(prov(tc).source("prep/raw").rows([2]).forward().to(tref).plan())
    same_records(got, rs.run(rprov(rc).source("prep/raw").rows([2]).forward().to(rref).plan()))
    assert got.tolist() == [1, 2]
    batch = [[0], [1], [2], [3], [1, 2]]
    got = ts.run(prov(tc).source(tref).rows_batch(batch).backward().to("prep/raw").plan())
    assert [g.tolist() for g in got] == [[5], [2], [2], [], [2]]
    same_records(got, rs.run(rprov(rc).source(rref).rows_batch(batch).backward()
                             .to("prep/raw").plan()))
    same_counters(rs, ts)
    same_store(rs, ts, Ids(rc, tc))


@pytest.mark.parametrize("seed", range(6))
def test_link_stitch_and_matrix_match_reference(seed):
    """Random alignments with duplicates and -1: stitch_down / stitch_up
    (the device scatter-OR) and the selection matrix equal ``repro``'s."""
    rng = np.random.default_rng(seed)
    n_up, n_down, B = int(rng.integers(1, 40)), int(rng.integers(1, 60)), 5
    align = rng.integers(-1, n_up, size=n_down)
    r_link = RLink(up="a/x", down="b/y", alignment=align)
    t_link = Link(up="a/x", down="b/y", alignment=torch.from_numpy(align))
    assert t_link.n_linked == int((align >= 0).sum())
    up = rng.random((B, n_up)) < 0.3
    down = rng.random((B, n_down)) < 0.3
    np.testing.assert_array_equal(t_link.stitch_down(torch.from_numpy(up), n_down).numpy(),
                                  r_link.stitch_down(up, n_down))
    np.testing.assert_array_equal(t_link.stitch_up(torch.from_numpy(down), n_up).numpy(),
                                  r_link.stitch_up(down, n_up))
    same_csr(t_link.matrix(n_up, n_down), r_link.matrix(n_up, n_down).tocsr())
    ident = Link(up="a/x", down="b/y", alignment=None)
    same_csr(ident.matrix(n_up, n_up), RLink("a/x", "b/y", None).matrix(n_up, n_up))
    assert ident.stitch_up(torch.from_numpy(up), n_up) is not None


# ===========================================================================
# Validation, cycles, devices
# ===========================================================================
def _validation_world(pkg):
    if pkg == "repro":
        Index, T, trk, Cat, kw = RIndex, RTable, rtrack, RCatalog, {}
    else:
        Index, T, trk, Cat, kw = ProvenanceIndex, Table, track, ProvCatalog, {"device": CPU}
    prep = Index("prep", **kw)
    t = trk(T.from_columns({"x": np.ones(4, np.float32)}, **kw), prep, "raw")
    derived = t.value_transform("x", "scale", factor=2.0)
    serve = Index("serve", **kw)
    trk(T.from_columns({"x": np.ones(3, np.float32)}, **kw), serve, "req")
    serve2 = Index("serve2", **kw)
    s2 = trk(T.from_columns({"x": np.ones(4, np.float32)}, **kw), serve2, "req2")
    d2 = s2.value_transform("x", "scale", factor=2.0)
    catalog = Cat(**kw)
    catalog.register("prep", prep).register("serve", serve).register("serve2", serve2)
    return catalog, prep, derived.dataset_id, d2.dataset_id


_BAD_LINKS = [
    ("different members", lambda d, d2: ("prep/raw", f"prep/{d}"), {}),
    ("equal row counts", lambda d, d2: ("prep/raw", "serve/req"), {}),
    ("shape", lambda d, d2: ("prep/raw", "serve/req"), {"alignment": [0, 1]}),
    (r"\[-1", lambda d, d2: ("prep/raw", "serve/req"), {"alignment": [0, 1, 9]}),
    (r"\[-1", lambda d, d2: ("prep/raw", "serve/req"), {"alignment": [0, -2, 1]}),
    ("producer", lambda d, d2: ("prep/raw", f"serve2/{d2}"), {}),
    ("qualified", lambda d, d2: ("raw", "serve/req"), {}),
    ("unknown index", lambda d, d2: ("nope/raw", "serve/req"), {}),
]


@pytest.mark.parametrize("k", range(len(_BAD_LINKS)))
def test_link_validation_errors(k):
    """Each malformed link raises the same typed error in both packages,
    and declares nothing."""
    match, refs, kw = _BAD_LINKS[k]
    for pkg in ("repro", "port"):
        catalog, _, derived, d2 = _validation_world(pkg)
        err = FederationError if pkg == "port" else __import__(
            "repro.provenance", fromlist=["FederationError"]).FederationError
        with pytest.raises(err, match=match):
            catalog.link(*refs(derived, d2), **kw)
        assert catalog.links == []


def test_register_validation_and_device_checks():
    catalog, prep, _, _ = _validation_world("port")
    with pytest.raises(FederationError, match="already registered"):
        catalog.register("prep", prep)
    with pytest.raises(FederationError, match="member name"):
        catalog.register("a/b", prep)
    with pytest.raises(TypeError):
        catalog.register("x", object())

    class Elsewhere:                    # an index on another device
        name, device, datasets, producer = "far", torch.device("meta"), {}, {}

        def record(self, *a):
            pass

    with pytest.raises(FederationError, match="lies on meta"):
        catalog.register("far", Elsewhere())
    with pytest.raises(FederationError, match="lies on meta"):
        catalog.link("prep/raw", "serve2/req2",
                     alignment=torch.zeros(4, dtype=torch.int64, device="meta"))
    link = catalog.link("prep/raw", "serve2/req2", alignment=np.array([3, 2, -1, 0]))
    assert link.alignment.device == catalog.device and link.n_linked == 3
    assert catalog.member_of(prep) == "prep" and catalog.member_of(object()) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ProvCatalog()


def test_cyclic_link_graph_raises():
    a, b = ProvenanceIndex("a", device=CPU), ProvenanceIndex("b", device=CPU)
    ta = track(Table.from_columns({"x": np.ones(3, np.float32)}, device=CPU), a, "sa")
    tb = track(Table.from_columns({"x": np.ones(3, np.float32)}, device=CPU), b, "sb")
    a2 = ta.value_transform("x", "scale", factor=2.0)
    b2 = tb.value_transform("x", "scale", factor=2.0)
    catalog = ProvCatalog(device=CPU)
    catalog.register("a", a).register("b", b)
    catalog.link(f"a/{a2.dataset_id}", "b/sb")
    catalog.link(f"b/{b2.dataset_id}", "a/sa")
    with pytest.raises(FederationError, match="cycle"):
        prov(catalog).source("a/sa").rows([0]).forward().to(f"b/{b2.dataset_id}").run()


def test_cross_index_co_contributory_needs_via():
    _, (tc, trefs, tsink) = _worlds(5, 1)
    with pytest.raises(FederationError, match="via"):
        prov(tc).source(trefs[0]).rows([0]).co_contributory(tsink).run()
    with pytest.raises(FederationError, match="via"):
        tc.session().explain(prov(tc).source(trefs[0]).rows([0]).co_contributory(tsink).plan())


def test_bad_refs_raise():
    _, (tc, trefs, tsink) = _worlds(5, 2)
    with pytest.raises(KeyError, match="index-qualified"):
        prov(tc).source("src")
    with pytest.raises(KeyError, match="registered indexes"):
        prov(tc).source("nope/src")
    with pytest.raises(KeyError):
        prov(tc).source(trefs[0]).rows([0]).forward().to("serve/never")
    plan = QueryPlan(kind="record", source="ghost/x", target=tsink, direction="fwd",
                     rows=torch.ones((1, 3), dtype=torch.bool))
    with pytest.raises(FederationError, match="unknown index"):
        tc.session().run(plan)


# ===========================================================================
# Cells / how across links
# ===========================================================================
@pytest.mark.parametrize("seed", SEEDS)
def test_federated_cells_parity(seed):
    cut = _cut(seed, 3000)
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
    rng = np.random.default_rng(seed + 3000)
    n_src, c_src = tc.datasets[trefs[0]].n_rows, tc.datasets[trefs[0]].n_cols
    n_sink, c_sink = tc.datasets[tsink].n_rows, tc.datasets[tsink].n_cols
    for rows in _row_probes(rng, n_src):
        attrs = sorted(set(rng.integers(0, c_src, 2).tolist()))
        got = prov(tc).source(trefs[0]).rows(rows).attrs(attrs).forward().to(tsink).run()
        want = rprov(rc).source(rrefs[0]).rows(rows).attrs(attrs).forward().to(rsink).run()
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    rows = [int(rng.integers(0, n_sink))]
    for rr, tr in zip(rrefs, trefs):
        got = prov(tc).source(tsink).rows(rows).attrs(list(range(c_sink))).backward().to(tr).run()
        want = rprov(rc).source(rsink).rows(rows).attrs(list(range(c_sink))).backward() \
            .to(rr).run()
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    same_counters(rc.session(), tc.session())


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_federated_how_parity(seed):
    """Record+how and cells+how: answers and FULL hop traces (op ids,
    names, categories, datasets, counts), the link hops included."""
    cut = _cut(seed, 4000)
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
    ids = Ids(rc, tc)
    rng = np.random.default_rng(seed + 4000)
    n_src = tc.datasets[trefs[0]].n_rows
    n_sink = tc.datasets[tsink].n_rows
    rows = sorted(set(rng.integers(0, n_sink, 3).tolist()))
    g_recs, g_hops = prov(tc).source(tsink).rows(rows).backward().to(trefs[0]).how().run()
    w_recs, w_hops = rprov(rc).source(rsink).rows(rows).backward().to(rrefs[0]).how().run()
    same_records(g_recs, w_recs)
    same_hops(g_hops, w_hops, ids)
    assert sum(1 for h in g_hops if h.category == "link") == 1
    rows = [int(rng.integers(0, n_src))]
    g_recs, g_hops = prov(tc).source(trefs[0]).rows(rows).forward().to(tsink).how().run()
    w_recs, w_hops = rprov(rc).source(rrefs[0]).rows(rows).forward().to(rsink).how().run()
    same_records(g_recs, w_recs)
    same_hops(g_hops, w_hops, ids)
    c_src = tc.datasets[trefs[0]].n_cols
    probes = [[], [0], sorted(set(rng.integers(0, n_src, 3).tolist()))]
    got = prov(tc).source(trefs[0]).rows_batch(probes).attrs(list(range(c_src))) \
        .forward().to(tsink).how().run()
    want = rprov(rc).source(rrefs[0]).rows_batch(probes).attrs(list(range(c_src))) \
        .forward().to(rsink).how().run()
    for (gc, gh), (wc, wh) in zip(got, want):
        np.testing.assert_array_equal(gc.numpy().reshape(wc.shape), wc)
        same_hops(gh, wh, ids)
    same_counters(rc.session(), tc.session())


@pytest.mark.parametrize("seed", [1, 2])
def test_federated_cells_diamond_both_links_contribute(seed):
    _, _, rc, rsink = pipegen.cross_boundary_diamond(seed)
    tc, tsink = cross_boundary_diamond(seed)
    ids = Ids(rc, tc)
    for rows in ([0], [2, 5]):
        got = prov(tc).source("prep/src").rows(rows).attrs([0, 1]).forward().to(tsink).how().run()
        want = rprov(rc).source("prep/src").rows(rows).attrs([0, 1]).forward() \
            .to(rsink).how().run()
        np.testing.assert_array_equal(got[0].numpy().reshape(want[0].shape), want[0])
        same_hops(got[1], want[1], ids)
        assert sum(1 for h in got[1] if h.category == "link") == 2


def test_cells_realign_attributes_by_column_name():
    """Columns re-align BY NAME across a link: serve's boundary source
    holds the prep boundary's columns in another order plus one of its own;
    a column with no counterpart drops."""
    def world(pkg):
        if pkg == "repro":
            Index, T, trk, Cat, kw = RIndex, RTable, rtrack, RCatalog, {}
        else:
            Index, T, trk, Cat, kw = ProvenanceIndex, Table, track, ProvCatalog, {"device": CPU}
        rng = np.random.default_rng(7)
        prep = Index("prep", **kw)
        s = trk(T.from_columns({"a": rng.normal(size=6).astype(np.float32),
                                "b": rng.normal(size=6).astype(np.float32),
                                "c": rng.normal(size=6).astype(np.float32)}, **kw), prep, "raw")
        clean = s.value_transform("a", "scale", factor=2.0)
        serve = Index("serve", **kw)
        ing = trk(T.from_columns({"c": np.ones(6, np.float32), "z": np.ones(6, np.float32),
                                  "a": np.ones(6, np.float32)}, **kw), serve, "ingest")
        out = ing.value_transform("z", "scale", factor=3.0).mark_sink()
        cat = Cat("names", **kw)
        cat.register("prep", prep).register("serve", serve)
        cat.link(qualify("prep", clean.dataset_id), "serve/ingest")
        return cat, qualify("serve", out.dataset_id)

    rc, rsink = world("repro")
    tc, tsink = world("port")
    ids = Ids(rc, tc)
    for attrs in ([0], [2], [0, 2], [0, 1, 2]):
        got = prov(tc).source("prep/raw").rows([1, 4]).attrs(attrs).forward().to(tsink).how().run()
        want = rprov(rc).source("prep/raw").rows([1, 4]).attrs(attrs).forward().to(rsink) \
            .how().run()
        np.testing.assert_array_equal(got[0].numpy().reshape(want[0].shape), want[0])
        same_hops(got[1], want[1], ids)
    for attrs in ([0], [2], [0, 1, 2]):
        got = prov(tc).source(tsink).rows([3]).attrs(attrs).backward().to("prep/raw").run()
        want = rprov(rc).source(rsink).rows([3]).attrs(attrs).backward().to("prep/raw").run()
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # an attribute set that drops whole at the link ("b" forward, "z"
    # backward): the port answers no cells; repro raises from its term
    # walker, handed only an empty term list (ROADMAP C)
    for start, end, d in (("prep/raw", tsink, "fwd"), (tsink, "prep/raw", "bwd")):
        q = prov(tc).source(start).rows([1, 3]).attrs([1])
        got = (q.forward() if d == "fwd" else q.backward()).to(end).how().run()
        assert got[0].shape == (0, 2) and not any(h.category == "link" for h in got[1])
    with pytest.raises(ValueError, match="non-empty entry term list"):
        rprov(rc).source("prep/raw").rows([1, 3]).attrs([1]).forward().to(rsink).run()


def test_single_member_plans_delegate_with_full_kind_support():
    base, specs = pipegen.random_specs(6)
    rc, rrefs, rsink = pipegen.build_federated(base, specs, len(specs))
    tc, trefs, tsink = build_federated(base, specs, len(specs))
    j = len(trefs) - 2 if trefs[-1].startswith("serve") else len(trefs) - 1
    got = prov(tc).source(trefs[0]).rows([0]).attrs([1]).forward().to(trefs[j]).run()
    want = rprov(rc).source(rrefs[0]).rows([0]).attrs([1]).forward().to(rrefs[j]).run()
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    recs, hops = prov(tc).source(trefs[0]).rows([0]).forward().to(trefs[j]).how().run()
    w_recs, w_hops = rprov(rc).source(rrefs[0]).rows([0]).forward().to(rrefs[j]).how().run()
    same_records(recs, w_recs)
    same_hops(hops, w_hops, Ids(rc, tc))
    meta = prov(tc).source(trefs[j]).transformations().run()
    w_meta = rprov(rc).source(rrefs[j]).transformations().run()
    assert [(m["op"], m["category"]) for m in meta] == [(m["op"], m["category"]) for m in w_meta]
    same_counters(rc.session(), tc.session())
    assert tc.session().counters["single_index"] >= 3
    assert tc.session().counters["federated"] == 0


# ===========================================================================
# run_many fusion across the boundary
# ===========================================================================
def test_run_many_fuses_federated_plans():
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(7, 2)
    n_sink = tc.datasets[tsink].n_rows
    rs, ts = RFed(rc), FederatedSession(tc)
    r_out = rs.run_many([rprov(rc).source(rsink).rows([i % n_sink]).backward().to(rrefs[0])
                         for i in range(12)])
    t_out = ts.run_many([prov(tc).source(tsink).rows([i % n_sink]).backward().to(trefs[0])
                         for i in range(12)])
    assert len(t_out) == 12
    same_records(t_out, r_out)
    same_counters(rs, ts)
    assert ts.counters["fused_groups"] == 1 and ts.counters["fused_plans"] == 12
    assert ts.counters["federated"] == 1
    # QuerySession and FederatedSession share ONE fusion rule
    assert TF.run_many_fused is TS.run_many_fused


# ===========================================================================
# The stitched cross relation and its catalog-owned store
# ===========================================================================
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_cross_relation_cache_parity(seed):
    """``cross_min_demand=0``: every cross route composes its stitched
    relation at once; answers, counters and the store (bytes, keys, each
    relation row by row) equal ``repro``'s, and nothing falls back to
    segments."""
    cut = _cut(seed, 3000)
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
    ids = Ids(rc, tc)
    rs, ts = RFed(rc, cross_min_demand=0), FederatedSession(tc, cross_min_demand=0)
    rng = np.random.default_rng(seed + 3000)
    n_src, n_sink = tc.datasets[trefs[0]].n_rows, tc.datasets[tsink].n_rows
    probes = [[], [0], sorted(set(rng.integers(0, n_sink, 4).tolist()))]
    same_records(ts.run(prov(tc).source(tsink).rows_batch(probes).backward().to(trefs[0]).plan()),
                 rs.run(rprov(rc).source(rsink).rows_batch(probes).backward().to(rrefs[0]).plan()))
    assert ts.counters["cross_composes"] == 1 and ts.counters["cross_probes"] == 1
    fprobes = [[i] for i in range(min(6, n_src))]
    same_records(ts.run(prov(tc).source(trefs[0]).rows_batch(fprobes).forward().to(tsink).plan()),
                 rs.run(rprov(rc).source(rrefs[0]).rows_batch(fprobes).forward().to(rsink).plan()))
    same_records(ts.run(prov(tc).source(tsink).rows([0]).backward().to(trefs[0]).plan()),
                 rs.run(rprov(rc).source(rsink).rows([0]).backward().to(rrefs[0]).plan()))
    assert ts.counters["cross_composes"] == 2 and ts.counters["cross_probes"] == 3
    assert ts.counters["segments"] == 0
    same_counters(rs, ts)
    same_store(rs, ts, ids)


def test_stitched_answers_equal_segment_answers_every_dataset():
    """The hot path never answers differently from the cold one: over one
    catalog, a segment session (budget 0: never stitches) and then a
    stitched session agree on every dataset across the link, both
    directions, every cut."""
    base, specs = pipegen.random_specs(4)
    for cut in range(1, len(specs)):
        cat, refs, sink = build_federated(base, specs, cut)
        plans = []
        for ref in refs:
            for src, d in ((refs[0], "fwd"), (sink, "bwd")):
                batch = [[i] for i in range(cat.datasets[src].n_rows)]
                q = prov(cat).source(src).rows_batch(batch)
                plans.append((q.forward() if d == "fwd" else q.backward()).to(ref).plan())
        cs = FederatedSession(cat, cross_budget_bytes=0)
        cold = [cs.run(p) for p in plans]
        assert cs.counters["cross_composes"] == 0
        hs = FederatedSession(cat, cross_min_demand=0, cross_budget_bytes=64 << 20)
        for p, want in zip(plans, cold):
            same_records(hs.run(p), [w.numpy() for w in want])
        assert hs.counters["segments"] == 0 and hs.counters["cross_probes"] > 0


def test_cross_relation_cache_diamond_and_alignment():
    _, _, rc, rsink = pipegen.cross_boundary_diamond(1)
    tc, tsink = cross_boundary_diamond(1)
    rs, ts = RFed(rc, cross_min_demand=0), FederatedSession(tc, cross_min_demand=0)
    n_src = tc.datasets["prep/src"].n_rows
    batch = [[i] for i in range(n_src)]
    same_records(ts.run(prov(tc).source("prep/src").rows_batch(batch).forward().to(tsink).plan()),
                 rs.run(rprov(rc).source("prep/src").rows_batch(batch).forward().to(rsink).plan()))
    assert ts.counters["cross_composes"] == 1        # BOTH links in one relation
    same_store(rs, ts, Ids(rc, tc))


def test_unroutable_cross_compose_memoized_as_failed():
    def world(pkg):
        if pkg == "repro":
            Index, T, trk, Cat, kw = RIndex, RTable, rtrack, RCatalog, {}
        else:
            Index, T, trk, Cat, kw = ProvenanceIndex, Table, track, ProvCatalog, {"device": CPU}
        prep = Index("prep", **kw)
        t = trk(T.from_columns({"x": np.ones(5, np.float32)}, **kw), prep, "raw")
        a = t.value_transform("x", "scale", factor=2.0)
        trk(T.from_columns({"x": np.ones(3, np.float32)}, **kw), prep, "orphan")
        serve = Index("serve", **kw)
        s = trk(a.table, serve, "ingest")
        out = s.value_transform("x", "scale", factor=3.0).mark_sink()
        cat = Cat(**kw)
        cat.register("prep", prep).register("serve", serve)
        cat.link(qualify("prep", a.dataset_id), "serve/ingest")
        return cat, qualify("serve", out.dataset_id)

    rc, rout = world("repro")
    tc, tout = world("port")
    rs, ts = RFed(rc, cross_min_demand=0), FederatedSession(tc, cross_min_demand=0)
    for _ in range(2):
        got = ts.run(prov(tc).source("prep/orphan").rows([0]).forward().to(tout).plan())
        rs.run(rprov(rc).source("prep/orphan").rows([0]).forward().to(rout).plan())
        assert got.numel() == 0
        assert ts.counters["cross_composes"] == 0 and len(ts._cross_failed) == 1
        same_counters(rs, ts)
    ok = ts.run(prov(tc).source(tout).rows([0]).backward().to("prep/raw").plan())
    rs.run(rprov(rc).source(rout).rows([0]).backward().to("prep/raw").plan())
    assert ok.tolist() == [0] and ts.counters["cross_composes"] == 1
    same_store(rs, ts, Ids(rc, tc))


def _serving_world(pkg):
    """prep/raw -> clean, exported; serve/requests@0 aligned to it."""
    if pkg == "repro":
        Index, T, trk, Cat, kw = RIndex, RTable, rtrack, RCatalog, {}
    else:
        Index, T, trk, Cat, kw = ProvenanceIndex, Table, track, ProvCatalog, {"device": CPU}
    prep = Index("prep", **kw)
    s = trk(T.from_columns({"k": np.arange(8, dtype=np.float32),
                            "x": np.ones(8, np.float32)}, **kw), prep, "raw")
    clean = s.filter_rows(np.array([1, 1, 0, 1, 1, 0, 1, 1], bool))
    serve = Index("serve", **kw)
    cat = Cat("serving", **kw)
    cat.register("prep", prep.export(clean.dataset_id)).register("serve", serve)

    def generation(n, request_rows):
        req = trk(T.from_columns({"x": np.ones(len(request_rows), np.float32)}, **kw),
                  serve, f"requests@{n}")
        out = req.value_transform("x", "scale", factor=2.0).mark_sink()
        cat.link(qualify("prep", clean.dataset_id), f"serve/requests@{n}",
                 alignment=np.asarray(request_rows))
        return qualify("serve", out.dataset_id)

    return cat, generation


def test_cross_relation_survives_unrelated_links():
    """One new link per recorded generation, landing on a brand-new
    ``requests@N``: no cached route reaches it, so the hot stitched
    relation survives the link-set change (the serving pattern, without
    the serving engine)."""
    rc, r_gen = _serving_world("repro")
    tc, t_gen = _serving_world("port")
    rs, ts = RFed(rc, cross_min_demand=0), FederatedSession(tc, cross_min_demand=0)
    r_out, t_out = r_gen(0, [0, 1, 2]), t_gen(0, [0, 1, 2])
    first = ts.run(prov(tc).source(t_out).rows([1]).backward().to("prep/raw").plan())
    rs.run(rprov(rc).source(r_out).rows([1]).backward().to("prep/raw").plan())
    assert first.tolist() == [1] and ts.counters["cross_composes"] == 1
    r_gen(1, [3, 0]), t_gen(1, [3, 0])
    again = ts.run(prov(tc).source(t_out).rows([1]).backward().to("prep/raw").plan())
    rs.run(rprov(rc).source(r_out).rows([1]).backward().to("prep/raw").plan())
    assert torch.equal(again, first)
    assert ts.counters["cross_composes"] == 1 and ts.counters["cross_probes"] == 2
    same_counters(rs, ts)
    same_store(rs, ts, Ids(rc, tc))


def test_cross_relation_invalidates_on_new_link():
    """A stitched relation must not survive a link-set change that alters
    what it stitches through: the second branch link recomposes it, and the
    answer becomes the merged one."""
    def partial(pkg, seed=2):
        if pkg == "repro":
            _, _, cat, sink = pipegen.cross_boundary_diamond(seed)
            Cat, kw = RCatalog, {}
        else:
            cat, sink = cross_boundary_diamond(seed)
            Cat, kw = ProvCatalog, {"device": CPU}
        part = Cat("partial", **kw)
        part.register("prep", cat.members["prep"]._index)
        part.register("serve", cat.members["serve"]._index)
        link_a, link_b = cat.links
        part.link(link_a.up, link_a.down)
        return part, sink, link_b

    rc, rsink, r_b = partial("repro")
    tc, tsink, t_b = partial("port")
    rs, ts = RFed(rc, cross_min_demand=0), FederatedSession(tc, cross_min_demand=0)
    rows = list(range(tc.datasets["prep/src"].n_rows))
    one = ts.run(prov(tc).source("prep/src").rows(rows).forward().to(tsink).plan())
    same_records(one, rs.run(rprov(rc).source("prep/src").rows(rows).forward().to(rsink).plan()))
    rc.link(r_b.up, r_b.down)
    tc.link(t_b.up, t_b.down)
    both_ = ts.run(prov(tc).source("prep/src").rows(rows).forward().to(tsink).plan())
    same_records(both_, rs.run(rprov(rc).source("prep/src").rows(rows).forward()
                               .to(rsink).plan()))
    assert ts.counters["cross_composes"] == 2 and one.numel() <= both_.numel()
    same_store(rs, ts, Ids(rc, tc))


def test_cross_store_lru_evicts_like_reference():
    """A budget that holds one stitched relation: the second route evicts
    the first, by the same byte count in both packages."""
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(0, 2)
    ids = Ids(rc, tc)
    c2, refs2, sink2 = build_federated(*pipegen.random_specs(0), 2)
    probe = FederatedSession(c2, cross_min_demand=0)
    probe.run(prov(c2).source(sink2).rows([0]).backward().to(refs2[0]).plan())
    budget = probe._cross_bytes + 8
    rs = RFed(rc, cross_min_demand=0, cross_budget_bytes=budget)
    ts = FederatedSession(tc, cross_min_demand=0, cross_budget_bytes=budget)
    for r_src, r_dst, t_src, t_dst, d in ((rsink, rrefs[0], tsink, trefs[0], "bwd"),
                                          (rrefs[0], rsink, trefs[0], tsink, "fwd"),
                                          (rsink, rrefs[1], tsink, trefs[1], "bwd")):
        rq, tq = rprov(rc).source(r_src).rows([0]), prov(tc).source(t_src).rows([0])
        rq, tq = (rq.forward(), tq.forward()) if d == "fwd" else (rq.backward(), tq.backward())
        same_records(ts.run(tq.to(t_dst).plan()), rs.run(rq.to(r_dst).plan()))
        same_store(rs, ts, ids)
    assert ts._cross_bytes <= budget and ts.cross_budget_bytes == budget
    same_counters(rs, ts)


def test_cross_store_shared_across_sessions():
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(21, 2)
    a = FederatedSession(tc, cross_min_demand=0)
    plan = prov(tc).source(tsink).rows([0]).backward().to(trefs[0]).plan()
    got = a.run(plan)
    assert a.counters["cross_composes"] == 1
    b = FederatedSession(tc, cross_min_demand=0)
    assert b._store is a._store is tc._cross_store and len(b._cross) == 1
    assert torch.equal(b.run(plan), got)
    assert b.counters["cross_composes"] == 0 and b.counters["cross_probes"] == 1
    ra, rb = RFed(rc, cross_min_demand=0), RFed(rc, cross_min_demand=0)
    rplan = rprov(rc).source(rsink).rows([0]).backward().to(rrefs[0]).plan()
    ra.run(rplan)
    rb.run(rplan)
    same_counters(ra, a)
    same_counters(rb, b)
    same_store(rb, b, Ids(rc, tc))


def test_cost_gate_budget_zero_never_stitches():
    """The default gate with ``cross_budget_bytes=0`` keeps segments
    forever (demand tracked as in ``repro``); the stitched twin answers
    the same."""
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(22, 2)
    ids = Ids(rc, tc)
    rs, ts = RFed(rc, cross_budget_bytes=0), FederatedSession(tc, cross_budget_bytes=0)
    plan = prov(tc).source(tsink).rows([0]).backward().to(trefs[0]).plan()
    rplan = rprov(rc).source(rsink).rows([0]).backward().to(rrefs[0]).plan()
    got = ts.run(plan)
    rs.run(rplan)
    for _ in range(40):
        assert torch.equal(ts.run(plan), got)
        rs.run(rplan)
    assert ts.counters["cross_composes"] == 0 and ts.counters["segments"] > 0
    assert any(v > 40 for v in ts._route_demand.values())
    same_counters(rs, ts)
    same_store(rs, ts, ids)
    c2, refs2, sink2 = build_federated(*pipegen.random_specs(22), 2)
    stitch = FederatedSession(c2, cross_min_demand=0)
    assert torch.equal(stitch.run(prov(c2).source(sink2).rows([0]).backward()
                                  .to(refs2[0]).plan()), got)
    assert stitch.counters["cross_composes"] == 1


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_default_gate_flips_like_reference(seed):
    """The default cost gate under a stream of probes: the batch at which
    a route flips to its stitched relation, and every counter on the way,
    equal ``repro``'s."""
    cut = _cut(seed, 5000)
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, cut)
    ids = Ids(rc, tc)
    n_sink = tc.datasets[tsink].n_rows
    for i in range(24):
        batch = [[(i + b) % n_sink] for b in range(8)]
        same_records(prov(tc).source(tsink).rows_batch(batch).backward().to(trefs[0]).run(),
                     rprov(rc).source(rsink).rows_batch(batch).backward().to(rrefs[0]).run())
        same_counters(rc.session(), tc.session())
    same_store(rc.session(), tc.session(), ids)


def test_cross_route_choose_stats_fallback_demand_floor():
    floor = TCM.CROSS_FALLBACK_MIN_DEMAND
    assert floor == RCM.CROSS_FALLBACK_MIN_DEMAND
    for demand in (floor - 1, floor):
        t = TCM.cross_route_choose([None], 0.0, 1, demand)
        r = RCM.cross_route_choose([None], 0.0, 1, demand)
        assert (t["strategy"], t["estimated"]) == (r["strategy"], r["estimated"])
    assert TCM.cross_route_choose([None], 0.0, 1, floor)["strategy"] == "stitched"


@pytest.mark.parametrize("seed", [23, 24])
def test_member_relation_stats_price_the_route(seed):
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, 2)
    ids = Ids(rc, tc)
    for name, member in tc.members.items():
        local = [split_ref(r)[1] for r in list(rrefs) + [rsink] if split_ref(r)[0] == name]
        if len(local) < 2:
            continue
        r_rel, r_ns = rc.members[name].relation_stats(local[0], local[-1])
        t_rel, t_ns = member.relation_stats(ids.per[name][local[0]], ids.per[name][local[-1]])
        assert t_ns == r_ns
        assert (t_rel is None) == (r_rel is None)
        if r_rel is not None:
            assert (t_rel.rows, t_rel.cols, t_rel.nnz, t_rel.structured) == \
                (r_rel.rows, r_rel.cols, r_rel.nnz, r_rel.structured)


# ===========================================================================
# relation_csr: the capability's relation read, per backend
# ===========================================================================
@pytest.mark.parametrize("backend", ["auto", "csr", "bitplane"])
@pytest.mark.parametrize("seed", [0, 5])
def test_relation_csr_matches_reference_and_leaves_the_cache(seed, backend):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    rci, tci = RComposed(r_idx, backend=backend), ComposedIndex(t_idx, backend=backend)
    for r_dst, t_dst in zip(r_ids, t_ids):
        backends = (tci.relation_backend("src", t_dst), rci.relation_backend("src", r_dst))
        assert backends[0] == backends[1]
        before = tci.stats()
        t_rel = tci.relation_csr("src", t_dst)
        r_rel = rci.relation_csr("src", r_dst)
        same_csr(t_rel, rsp.csr_matrix(r_rel))
        after = tci.stats()
        assert tci.relation_backend("src", t_dst) == rci.relation_backend("src", r_dst)
        assert after["conversions"] == before["conversions"]
        assert after["bytes"] == before["bytes"] and after["entries"] == before["entries"]
        # a COPY: writing into it leaves the cached relation as it was
        t_rel.values().zero_()
        same_csr(tci.relation_csr("src", t_dst), rsp.csr_matrix(rci.relation_csr("src", r_dst)))
    assert tci.stats()["hits"] == rci.stats()["hits"]
    assert tci.stats()["misses"] == rci.stats()["misses"]


# ===========================================================================
# Capabilities
# ===========================================================================
def _capability_fixture(pkg):
    if pkg == "repro":
        Index, T, trk, kw = RIndex, RTable, rtrack, {}
        mask = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    else:
        Index, T, trk, kw = ProvenanceIndex, Table, track, {"device": CPU}
        mask = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    prep = Index("prep", **kw)
    s = trk(T.from_columns({"k": np.arange(8, dtype=np.float32),
                            "x": np.ones(8, np.float32)}, **kw), prep, "raw")
    exported = s.filter_rows(mask)
    sibling = s.value_transform("x", "scale", factor=2.0)   # NOT an ancestor
    downstream = exported.value_transform("x", "scale", factor=3.0)
    return prep, exported, sibling, downstream


def test_boundary_handle_denies_mutation_and_non_ancestors():
    prep, exported, sibling, downstream = _capability_fixture("port")
    handle = prep.export(exported.dataset_id)
    assert isinstance(handle, BoundaryHandle) and handle.device == prep.device
    with pytest.raises(CapabilityError, match="read-only"):
        handle.record([], "x", None, None)
    with pytest.raises(CapabilityError, match="read-only"):
        handle.add_source("y", None)
    assert exported.dataset_id in handle.datasets and "raw" in handle.datasets
    assert sibling.dataset_id not in handle.datasets
    for ds in (sibling.dataset_id, downstream.dataset_id):
        with pytest.raises(CapabilityError, match="not an ancestor"):
            handle.datasets[ds]
    with pytest.raises(KeyError):
        handle.datasets["never-existed"]
    assert set(handle.datasets) == {"raw", exported.dataset_id} and len(handle.datasets) == 2
    plan = QueryPlan(kind="record", source="raw", target=sibling.dataset_id, direction="fwd",
                     rows=torch.ones((1, 8), dtype=torch.bool))
    for verb in (handle.run, handle.run_masks, handle.explain, lambda p: handle.run_many([p])):
        with pytest.raises(CapabilityError, match="not an ancestor"):
            verb(plan)
    with pytest.raises(CapabilityError):
        handle.path_exists("raw", downstream.dataset_id)
    with pytest.raises(CapabilityError):
        handle.relation_csr("raw", sibling.dataset_id)
    with pytest.raises(CapabilityError):
        handle.relation_stats("raw", sibling.dataset_id)
    with pytest.raises(CapabilityError):
        handle.run_record_terms({sibling.dataset_id: torch.ones((1, 8), dtype=torch.bool)}, "fwd")
    ok = QueryPlan(kind="record", source="raw", target=exported.dataset_id, direction="fwd",
                   rows=torch.ones((1, 8), dtype=torch.bool))
    r_prep, r_exported, _, _ = _capability_fixture("repro")
    want = rprov(r_prep).source("raw").rows(list(range(8))).forward() \
        .to(r_exported.dataset_id).run()
    same_records(handle.run(ok), want)
    same_records(handle.run_many([ok, ok]), [want, want])
    narrower = handle.export("raw")
    assert set(narrower.datasets) == {"raw"}
    with pytest.raises(CapabilityError):
        handle.export(sibling.dataset_id)
    assert "ancestor datasets" in repr(handle)


def test_boundary_handle_filters_hop_traces_to_ancestors():
    """A walk through a handle that escapes the ancestor closure reveals
    nothing outside it: masks and hop traces filtered exactly as in
    ``repro``."""
    r_prep, r_exp, _, _ = _capability_fixture("repro")
    t_prep, t_exp, _, _ = _capability_fixture("port")
    rh, th = r_prep.export(r_exp.dataset_id), t_prep.export(t_exp.dataset_id)
    ids = id_map(r_prep, t_prep)
    seed = np.zeros((2, 8), bool)
    seed[0, [0, 3]] = True
    seed[1, 2] = True
    r_masks, r_hops = rh.run_record_terms({"raw": seed}, "fwd", collect_hops=True)
    t_masks, t_hops = th.run_record_terms({"raw": torch.from_numpy(seed)}, "fwd",
                                          collect_hops=True)
    assert sorted(t_masks) == sorted(ids[d] for d in r_masks)
    for d, m in r_masks.items():
        np.testing.assert_array_equal(t_masks[ids[d]].numpy(), m)
    for g, w in zip(t_hops, r_hops):
        assert [hop_key(h) for h in g] == [(h.op_id, h.op_name, h.category, ids[h.src_dataset],
                                            ids[h.dst_dataset], h.n_records) for h in w]
    attrs = np.ones((2, 2), bool)
    r_terms, r_b, r_th = rh.run_attr_terms(
        {"raw": [(seed, r_pack(attrs))]}, "fwd", collect_hops=True)
    t_terms, t_b, t_th = th.run_attr_terms(
        {"raw": [(torch.from_numpy(seed), pack_bitplane(torch.from_numpy(attrs)))]}, "fwd",
        collect_hops=True)
    assert t_b == r_b and sorted(t_terms) == sorted(ids[d] for d in r_terms)
    for g, w in zip(t_th, r_th):
        assert [hop_key(h) for h in g] == [(h.op_id, h.op_name, h.category, ids[h.src_dataset],
                                            ids[h.dst_dataset], h.n_records) for h in w]
    t_terms2, _ = th.run_attr_terms(
        {"raw": [(torch.from_numpy(seed), pack_bitplane(torch.from_numpy(attrs)))]}, "fwd")
    assert sorted(t_terms2) == sorted(t_terms)
    assert sorted(th.run_record_terms({"raw": torch.from_numpy(seed)}, "fwd")) == sorted(t_masks)


def test_catalog_resolution_respects_capabilities():
    prep, exported, sibling, _ = _capability_fixture("port")
    catalog = ProvCatalog(device=CPU)
    catalog.register("up", prep.export(exported.dataset_id))
    assert qualify("up", "raw") in catalog.datasets
    assert qualify("up", sibling.dataset_id) not in catalog.datasets
    assert "garbage" not in catalog.datasets
    with pytest.raises(CapabilityError):
        catalog.datasets[qualify("up", sibling.dataset_id)]
    with pytest.raises(KeyError):
        prov(catalog).source(qualify("up", sibling.dataset_id))
    assert sorted(catalog.datasets) == sorted(qualify("up", d)
                                              for d in ("raw", exported.dataset_id))


def test_federation_through_a_boundary_handle_member():
    """An upstream member registered as a read-only capability answers
    cross-member lineage (segments and the stitched relation) like the
    full index would, and like ``repro``."""
    rc, r_gen = _serving_world("repro")
    tc, t_gen = _serving_world("port")
    r_out, t_out = r_gen(0, [0, 2, 2, 5]), t_gen(0, [0, 2, 2, 5])
    for demand in (None, 0):
        rs = RFed(rc) if demand is None else RFed(rc, cross_min_demand=0)
        ts = FederatedSession(tc) if demand is None else FederatedSession(tc, cross_min_demand=0)
        batch = [[0], [1], [2], [3], [1, 3]]
        for dst in ("prep/raw",):
            got = ts.run(prov(tc).source(t_out).rows_batch(batch).backward().to(dst).plan())
            same_records(got, rs.run(rprov(rc).source(r_out).rows_batch(batch).backward()
                                     .to(dst).plan()))
        got = ts.run(prov(tc).source("prep/raw").rows([3]).forward().to(t_out).plan())
        same_records(got, rs.run(rprov(rc).source("prep/raw").rows([3]).forward()
                                 .to(r_out).plan()))
        same_counters(rs, ts)


# ===========================================================================
# explain / stats
# ===========================================================================
@pytest.mark.parametrize("seed", [9, 10])
def test_explain_matches_reference(seed):
    """Per-segment strategies and costs, links and the top-level verdict
    equal ``repro``'s for record, co-query and cells plans, and a
    single-member plan surfaces its member's own verdict."""
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(seed, 2)
    ids = Ids(rc, tc)
    rs, ts = rc.session(), tc.session()
    cases = [
        lambda p, f: p.source(f(rsink)).rows([0]).backward().to(f(rrefs[0])),
        lambda p, f: p.source(f(rrefs[0])).rows_batch([[0], [1]]).forward().to(f(rsink)),
        lambda p, f: p.source(f(rrefs[0])).rows([0]).attrs([0]).forward().to(f(rsink)),
        lambda p, f: p.source(f(rrefs[0])).rows([0]).co_contributory(f(rrefs[1]), via=f(rsink)),
        lambda p, f: p.source(f(rsink)).rows([0]).co_dependency(f(rrefs[0]), f(rsink)),
        lambda p, f: p.source(f(rrefs[0])).rows([0]).forward().to(f(rrefs[1])),
    ]
    for case in cases:
        r_ex = rs.explain(case(rprov(rc), lambda r: r).plan())
        t_ex = ts.explain(case(prov(tc), ids.ref).plan())
        r_ex.pop("constants", None)
        t_ex.pop("constants", None)
        assert t_ex == ids.deep(r_ex)
    ex = ts.explain(cases[0](prov(tc), ids.ref).plan())
    assert ex["federated"] is True and {s["index"] for s in ex["segments"]} == {"prep", "serve"}
    assert len(ex["links"]) == 1
    assert ts.counters == rs.counters == {k: 0 for k in ts.counters}


def test_stats_aggregate_per_index_like_reference():
    (rc, rrefs, rsink), (tc, trefs, tsink) = _worlds(10, 2)
    prov(tc).source(tsink).rows([0]).backward().to(trefs[0]).run()
    rprov(rc).source(rsink).rows([0]).backward().to(rrefs[0]).run()
    t_st, r_st = tc.stats(), rc.stats()
    assert set(t_st) == {"federation", "indexes"} and set(t_st["indexes"]) == {"prep", "serve"}
    assert t_st["federation"] == r_st["federation"]
    for name in ("prep", "serve"):
        t_in, r_in = t_st["indexes"][name], r_st["indexes"][name]
        assert t_in["index"] == r_in["index"] == name
        assert t_in["planner"] == r_in["planner"]
        for k in ("entries", "bytes", "hits", "misses", "evictions", "extends", "recomposes"):
            assert t_in["hopcache"][k] == r_in["hopcache"][k], k
    assert t_st["federation"]["plans"] == 1 and t_st["federation"]["links_crossed"] == 1


def test_shared_session_on_catalog():
    _, (tc, _, _) = _worlds(11, 1)
    s1 = tc.session()
    assert tc.session() is s1 and s1.device == tc.device
    with pytest.raises(ValueError):
        tc.session(nope=1)
    assert "ProvCatalog('fed-cut1'" in repr(tc)


def test_plan_refs_split_ref_and_identity_link():
    p = QueryPlan(kind="record", source="a/x", target="b/y", direction="fwd",
                  rows=torch.ones((1, 3), dtype=torch.bool))
    assert p.refs() == ("a/x", "b/y")
    p = QueryPlan(kind="co_dependency", source="m", target="d3", anchor="d1",
                  rows=torch.ones((1, 3), dtype=torch.bool))
    assert set(p.refs()) == {"m", "d3", "d1"}
    assert split_ref("prep/a#1") == ("prep", "a#1") and split_ref("prep/a/b") == ("prep", "a/b")
    for bad in ("unqualified", "/ds", "prep/", None):
        with pytest.raises(FederationError):
            split_ref(bad)
    link = Link(up="a/x", down="b/y", alignment=None)
    up = torch.zeros((2, 4), dtype=torch.bool)
    up[0, 1] = True
    assert torch.equal(link.stitch_down(up, 4), up) and torch.equal(link.stitch_up(up, 4), up)
    assert link.n_linked is None
