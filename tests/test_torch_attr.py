"""Attribute-level queries in the port against the JAX package, exactly.

Q3/Q4 (cells) and Q7/Q8 (cells with hop traces), single and batched,
through ``repro_torch.provenance.prov(index)``, on pipelines replayed from
``pipegen.random_specs``, on the diamond, on the German, Compas and Census
use cases and on an index carried over with ``index_from_numpy``.  Cell lists (int64 ``(n, 2)``,
row-major) and hop traces must be equal to ``repro``'s; datasets are
aligned by op position.  Also held to ``repro``: the multi-seed term
walkers behind ``run_record_terms`` / ``run_attr_terms``, the Table-VI
scalar maps at every position, ``run_many`` fusion of cells plans, the
number of ``bitmatmul`` dispatches of the attribute walk (one per live
(op, input, term) hop, counted in ``repro`` as calls of its host
contraction) and the byte accounting of the attribute planes.  The port
runs on the CPU, where ``bitmatmul`` takes its plain version.
"""
import numpy as np
import pytest
import torch

import pipegen
from repro.core import query as RQ
from repro.core import schema as RS
from repro.core.opcat import AttrMap as RAttrMap
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import usecases as RU
from repro.provenance import prov as rprov
from repro_torch.core import query as TQ
from repro_torch.core import schema as TS
from repro_torch.core.carry import index_from_numpy
from repro_torch.core.opcat import AttrMap
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as TU
from repro_torch.kernels import ops as TK
from repro_torch.provenance import QuerySession, prov
from test_torch_capture import build_merged
from test_torch_query import _diamond, id_map, r_walk

CPU = "cpu"


def attr_probes(rng, n_rows, n_cols, b=4):
    """Row and attr probe sets: an empty row set first, then small sets."""
    rows = [[]] + [sorted(set(rng.integers(0, n_rows, 3).tolist())) for _ in range(b - 1)]
    attrs = [sorted(set(rng.integers(0, n_cols, 2).tolist())) for _ in range(b)]
    return rows, attrs


def same_cells(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def hop_key(h, ids=None):
    f = ids.__getitem__ if ids is not None else (lambda d: d)
    return (h.op_id, h.op_name, h.category, f(h.src_dataset), f(h.dst_dataset), h.n_records)


def same_how(got, want, ids):
    assert len(got) == len(want)
    same_cells([c for c, _ in got], [c for c, _ in want])
    for (_, gh), (_, wh) in zip(got, want):
        assert [hop_key(h) for h in gh] == [hop_key(h, ids) for h in wh]


def check_cells(r_idx, t_idx, r_src, r_sink, rng):
    """Q3/Q4/Q7/Q8 between ``r_src`` and ``r_sink`` in both packages."""
    ids = id_map(r_idx, t_idx)
    rs = r_walk(r_idx)
    for direction, r_from, r_to in (("fwd", r_src, r_sink), ("bwd", r_sink, r_src)):
        t_from, t_to = ids[r_from], ids[r_to]
        ds = r_idx.datasets[r_from]
        rows, attrs = attr_probes(rng, ds.n_rows, ds.n_cols)

        def build(p, src, dst):
            q = p.source(src).rows_batch(rows).attrs_batch(attrs)
            return (q.forward() if direction == "fwd" else q.backward()).to(dst)

        same_cells(build(prov(t_idx), t_from, t_to).run(),
                   build(rprov(r_idx), r_from, r_to).run(rs))
        same_how(build(prov(t_idx), t_from, t_to).how().run(),
                 build(rprov(r_idx), r_from, r_to).how().run(rs), ids)
        # one attr set broadcast over the row batch
        tq = prov(t_idx).source(t_from).rows_batch(rows).attrs(attrs[1])
        rq = rprov(r_idx).source(r_from).rows_batch(rows).attrs(attrs[1])
        tq, rq = (tq.forward(), rq.forward()) if direction == "fwd" else (tq.backward(), rq.backward())
        same_cells(tq.to(t_to).run(), rq.to(r_to).run(rs))
        for p, a in zip(rows, attrs):
            tq = prov(t_idx).source(t_from).rows(p).attrs(a)
            rq = rprov(r_idx).source(r_from).rows(p).attrs(a)
            tq, rq = (tq.forward(), rq.forward()) if direction == "fwd" \
                else (tq.backward(), rq.backward())
            same_cells([tq.to(t_to).run()], [rq.to(r_to).run(rs)])
            same_how([tq.how().run()], [rq.how().run(rs)], ids)


@pytest.mark.parametrize("seed", range(8))
def test_pipegen_cells_match_reference(seed):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    check_cells(r_idx, t_idx, "src", r_ids[-1], np.random.default_rng(seed))
    # every intermediate dataset as a target too (batched Q3 only)
    ids = id_map(r_idx, t_idx)
    rs = r_walk(r_idx)
    rows, attrs = attr_probes(np.random.default_rng(seed + 100),
                              r_idx.datasets["src"].n_rows, r_idx.datasets["src"].n_cols)
    for d in r_ids[1:-1]:
        same_cells(prov(t_idx).source("src").rows_batch(rows).attrs_batch(attrs)
                   .forward().to(ids[d]).run(),
                   rprov(r_idx).source("src").rows_batch(rows).attrs_batch(attrs)
                   .forward().to(d).run(rs))


def test_diamond_cells_match_reference():
    r_idx, r_sink = pipegen.diamond_pipeline(0)
    t_idx, _ = _diamond(0)
    check_cells(r_idx, t_idx, "src", r_sink, np.random.default_rng(0))


@pytest.mark.parametrize("name", ["german", "compas", "census"])
def test_use_case_cells_match_reference(name):
    r_idx = RIndex(name)
    r_sink = RU.USECASES[name][1](r_idx, RU.USECASES[name][0]()).dataset_id
    t_idx = ProvenanceIndex(name, device=CPU)
    TU.USECASES[name][1](t_idx, TU.USECASES[name][0](device=CPU))
    check_cells(r_idx, t_idx, r_idx.sources()[0], r_sink,
                np.random.default_rng(len(name)))


def _carried(r_idx):
    datasets = [{"id": d, "n_rows": r.n_rows, "n_cols": r.n_cols, "columns": r.columns,
                 "is_source": r.is_source, "is_sink": r.is_sink}
                for d, r in r_idx.datasets.items()]
    ops = [{"op_name": op.info.op_name, "category": op.info.category.value,
            "contextual": op.info.contextual, "input_ids": op.input_ids,
            "output_id": op.output_id, "payload": op.tensor.to_payload(),
            "attr_maps": [{"kind": a.kind,
                           "bitset": None if a.bitset is None
                           else {"n": a.bitset.n, "words": a.bitset.words},
                           "m": a.m, "perm": a.perm} for a in op.info.attr_maps]}
           for op in r_idx.ops]
    return index_from_numpy(datasets, ops, device=CPU)


@pytest.mark.parametrize("seed", [3, 5])
def test_carried_index_answers_cells_like_reference(seed):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    carried = _carried(r_idx)
    for ro, to in zip(r_idx.ops, carried.ops):
        assert [a.kind for a in to.info.attr_maps] == [a.kind for a in ro.info.attr_maps]
        for ta, ra in zip(to.info.attr_maps, ro.info.attr_maps):
            if ra.bitset is not None:
                assert ta.bitset.words.dtype == torch.int32
                np.testing.assert_array_equal(ta.bitset.words.numpy().view(np.uint32),
                                              ra.bitset.words)
    check_cells(r_idx, carried, "src", r_ids[-1], np.random.default_rng(seed))


def _multi_seed(seed):
    """A pipegen pipeline with at least one binary op, its entry datasets
    (the source and the binary op's second input) and probe stacks."""
    for s in range(seed, seed + 40):
        base, specs = pipegen.random_specs(s)
        if any(sp[0] in ("join", "append") for sp in specs):
            break
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    second = next(op.input_ids[1] for op in r_idx.ops if len(op.input_ids) == 2)
    rng = np.random.default_rng(seed)
    entries = {d: rng.random((3, r_idx.datasets[d].n_rows)) < 0.3 for d in ("src", second)}
    attrs = {d: rng.random((3, r_idx.datasets[d].n_cols)) < 0.5 for d in entries}
    return r_idx, r_ids, t_idx, entries, attrs


@pytest.mark.parametrize("seed", [0, 4])
def test_run_record_and_attr_terms_match_reference(seed):
    r_idx, r_ids, t_idx, entries, attrs = _multi_seed(seed)
    ids = id_map(r_idx, t_idx)
    rs, ts = r_walk(r_idx), QuerySession(t_idx)
    r_masks, r_hops = rs.run_record_terms(entries, "fwd", collect_hops=True)
    t_masks, t_hops = ts.run_record_terms(
        {ids[d]: torch.from_numpy(m) for d, m in entries.items()}, "fwd", collect_hops=True)
    assert sorted(t_masks) == sorted(ids[d] for d in r_masks)
    for d, m in r_masks.items():
        np.testing.assert_array_equal(t_masks[ids[d]].numpy(), m)
    assert [[hop_key(h) for h in hs] for hs in t_hops] == \
        [[hop_key(h, ids) for h in hs] for hs in r_hops]
    sink = r_ids[-1]
    back = {sink: np.random.default_rng(seed).random((3, r_idx.datasets[sink].n_rows)) < 0.4}
    r_b = rs.run_record_terms(back, "bwd")
    t_b = ts.run_record_terms({ids[sink]: torch.from_numpy(back[sink])}, "bwd")
    for d, m in r_b.items():
        np.testing.assert_array_equal(t_b[ids[d]].numpy(), m)

    r_entry = {d: [(m, RQ.pack_bitplane(attrs[d]))] for d, m in entries.items()}
    t_entry = {ids[d]: [(torch.from_numpy(m), TQ.pack_bitplane(torch.from_numpy(attrs[d])))]
               for d, m in entries.items()}
    r_terms, r_b, r_th = rs.run_attr_terms(r_entry, "fwd", collect_hops=True)
    t_terms, t_b, t_th = ts.run_attr_terms(t_entry, "fwd", collect_hops=True)
    assert t_b == r_b and sorted(t_terms) == sorted(ids[d] for d in r_terms)
    for d, terms in r_terms.items():
        assert len(t_terms[ids[d]]) == len(terms)
        for (trm, taw), (rrm, raw) in zip(t_terms[ids[d]], terms):
            np.testing.assert_array_equal(trm.numpy(), rrm)
            assert taw.dtype == torch.int32
            np.testing.assert_array_equal(taw.numpy().view(np.uint32), raw)
    assert [[hop_key(h) for h in hs] for hs in t_th] == \
        [[hop_key(h, ids) for h in hs] for hs in r_th]
    assert ts.counters["walk"] == 3 and ts.counters["plans"] == 3
    with pytest.raises(ValueError):
        ts.run_attr_terms({}, "fwd")
    with pytest.raises(ValueError):
        ts.run_record_terms({}, "fwd")


def _bitsets():
    rng = np.random.default_rng(9)
    out = [np.zeros(1, bool), np.ones(1, bool), np.ones(32, bool), np.ones(33, bool)]
    out += [rng.random(n) < 0.5 for n in (5, 31, 32, 33, 64, 70)]
    return out


def _same_map(name, rargs, targs):
    """``repro``'s map and the port's give the same answer, or both raise
    IndexError."""
    rfn, tfn = getattr(RS, name), getattr(TS, name)
    try:
        want = rfn(*rargs)
    except IndexError:
        with pytest.raises(IndexError):
            tfn(*targs)
        return
    assert tfn(*targs) == want


@pytest.mark.parametrize("k", range(len(_bitsets())))
def test_table_vi_maps_match_reference(k):
    bits = _bitsets()[k]
    rb, tb = RS.Bitset.from_bits(bits), TS.Bitset.from_bits(bits)
    n = len(bits)
    for i in range(n + 2):
        for name in ("map_vr_f", "map_vr_b", "map_join_f", "map_join_b"):
            _same_map(name, (rb, i), (tb, i))
        _same_map("map_va_f", (n, i), (n, i))
        _same_map("map_va_b", (rb, n // 2, i), (tb, n // 2, i))
    perm = np.random.default_rng(k).permutation(n).astype(np.int32)
    for i in range(n + 1):
        assert TS.perm_forward(torch.from_numpy(perm), i) == RS.perm_forward(perm, i)
    for j in range(n):
        assert TS.perm_backward(torch.from_numpy(perm), j) == RS.perm_backward(perm, j)
    np.testing.assert_array_equal(TS.rank_positions(tb).numpy(), RS.rank_positions(rb))


def test_run_many_fuses_cells_plans():
    base, specs = pipegen.random_specs(2)
    t_idx, ids = build_merged(base, specs)
    sink = ids[-1]
    n_src, n_dst = t_idx.datasets["src"].n_rows, t_idx.datasets[sink].n_rows
    plans = [
        prov(t_idx).source("src").rows([0, 1]).attrs([0]).forward().to(sink),
        prov(t_idx).source("src").rows_batch([[2], [n_src - 1]]).attrs_batch([[1], [0, 1]])
        .forward().to(sink),
        prov(t_idx).source(sink).rows([0]).attrs([0]).backward().to("src"),
        prov(t_idx).source("src").rows([3]).attrs([1]).forward().to(sink).how(),
        prov(t_idx).source(sink).rows_batch([[n_dst - 1]]).attrs([0, 1]).backward().to("src"),
        prov(t_idx).source("src").rows([1]).forward().to(sink),
    ]
    session = QuerySession(t_idx)
    got = session.run_many(plans)
    want = [QuerySession(t_idx).run(p.plan()) for p in plans]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    assert torch.equal(got[3][0], want[3][0]) and got[3][1] == want[3][1]
    assert all(torch.equal(g, w) for g, w in zip(got[4], want[4]))
    assert torch.equal(got[5], want[5])
    # the two forward cells plans fuse, and so do the two backward ones
    assert session.counters["fused_groups"] == 2 and session.counters["fused_plans"] == 4
    assert session.counters["plans"] == 6 and session.counters["walk"] >= 4


@pytest.mark.parametrize("seed", range(4))
def test_bitmatmul_dispatches_once_per_live_attribute_hop(seed, monkeypatch):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    ids = id_map(r_idx, t_idx)
    calls = []
    real = RQ.bitplane_or_reduce
    monkeypatch.setattr(RQ, "bitplane_or_reduce",
                        lambda *a: calls.append(1) or real(*a))
    rs = r_walk(r_idx)
    rows, attrs = attr_probes(np.random.default_rng(seed), r_idx.datasets["src"].n_rows,
                              r_idx.datasets["src"].n_cols)
    for direction, r_from, r_to in (("fwd", "src", r_ids[-1]), ("bwd", r_ids[-1], "src")):
        if direction == "bwd":
            rows, attrs = attr_probes(np.random.default_rng(seed), r_idx.datasets[r_from].n_rows,
                                      r_idx.datasets[r_from].n_cols)
        calls.clear()
        rq = rprov(r_idx).source(r_from).rows_batch(rows).attrs_batch(attrs)
        (rq.forward() if direction == "fwd" else rq.backward()).to(r_to).run(rs)
        TK.reset_launch_counts()
        tq = prov(t_idx).source(ids[r_from]).rows_batch(rows).attrs_batch(attrs)
        (tq.forward() if direction == "fwd" else tq.backward()).to(ids[r_to]).run()
        assert TK.launch_counts() == ({"bitmatmul": len(calls)} if calls else {})
        # and one per live hop of the single-probe walk
        calls.clear()
        RQ._attr_propagate(r_idx, r_from, rows[-1], attrs[-1], direction)
        TK.reset_launch_counts()
        TQ._attr_propagate(t_idx, ids[r_from], rows[-1], attrs[-1], direction)
        assert TK.launch_counts().get("bitmatmul", 0) == len(calls)
    TK.reset_launch_counts()


def test_attr_plane_bytes_and_prov_nbytes_match_reference():
    r_idx = RIndex("german")
    r_sink = RU.run_german(r_idx, RU.make_german()).dataset_id
    t_idx = ProvenanceIndex("german", device=CPU)
    TU.run_german(t_idx, TU.make_german(device=CPU))
    ids = id_map(r_idx, t_idx)
    src = r_idx.sources()[0]
    rs = r_walk(r_idx)
    rows, attrs = attr_probes(np.random.default_rng(1), r_idx.datasets[src].n_rows,
                              r_idx.datasets[src].n_cols)
    for a, b in ((src, r_sink), (r_sink, src)):
        rq = rprov(r_idx).source(a).rows_batch(rows[:2]).attrs_batch(attrs[:2])
        tq = prov(t_idx).source(ids[a]).rows_batch(rows[:2]).attrs_batch(attrs[:2])
        if a == src:
            rq.forward().to(b).run(rs), tq.forward().to(ids[b]).run()
        else:
            rq.backward().to(b).run(rs), tq.backward().to(ids[b]).run()
    for ro, to in zip(r_idx.ops, t_idx.ops):
        for ra, ta in zip(ro.info.attr_maps, to.info.attr_maps):
            assert sorted(ta._planes) == sorted(ra._planes)
            assert ta.nbytes() == ra.nbytes()
            assert all(p.device.type == "cpu" for p in ta._planes.values())
    assert t_idx.prov_nbytes() == r_idx.prov_nbytes()


@pytest.mark.parametrize("kind", ["identity", "vreduce", "vaugment", "join"])
def test_attr_plane_widths_pad_to_one_word(kind):
    """Both packages pad an attribute plane to at least one word, so the
    plane bytes (and ``AttrMap.nbytes``) agree at every width, zero
    included; a plane asked for on a second device raises."""
    bits = np.zeros(40, bool)
    bits[[0, 3, 31, 32, 39]] = True
    perm = np.array([3, -1, 0, 2], np.int32)
    args = {"identity": {}, "vreduce": {"bitset": bits}, "vaugment": {"bitset": bits, "m": 20},
            "join": {"bitset": bits, "perm": perm}}[kind]
    r = RAttrMap(kind, bitset=RS.Bitset.from_bits(args["bitset"]) if "bitset" in args else None,
                 m=args.get("m"), perm=args.get("perm"))
    t = AttrMap(kind, bitset=TS.Bitset.from_bits(args["bitset"]) if "bitset" in args else None,
                m=args.get("m"), perm=None if "perm" not in args else torch.from_numpy(perm))
    for n_in, n_out in ((0, 0), (1, 0), (0, 5), (31, 32), (33, 40), (40, 65)):
        for tf, rf in ((t.fwd_plane, r.fwd_plane), (t.bwd_plane, r.bwd_plane)):
            got, want = tf(n_in, n_out, CPU), rf(n_in, n_out)
            assert tuple(got.shape) == want.shape and got.shape[1] >= 1
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert t.nbytes() == r.nbytes()
    with pytest.raises(ValueError, match="memoised"):
        t.fwd_plane(0, 0, "meta")


@pytest.mark.parametrize("seed", range(4))
def test_single_probe_walkers_match_reference(seed):
    """The single-probe record walkers and term walk against ``repro``'s:
    every reachable dataset's mask, every term and the hop traces."""
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    ids = id_map(r_idx, t_idx)
    rng = np.random.default_rng(seed)
    for r_walk_fn, t_walk_fn, start, direction in (
            (RQ.forward_record_masks, TQ.forward_record_masks, "src", "fwd"),
            (RQ.backward_record_masks, TQ.backward_record_masks, r_ids[-1], "bwd")):
        ds = r_idx.datasets[start]
        rows = sorted(set(rng.integers(0, ds.n_rows, 3).tolist()))
        attrs = sorted(set(rng.integers(0, ds.n_cols, 2).tolist()))
        for how in (False, True):
            r_masks, r_hops = r_walk_fn(r_idx, start, rows, collect_hops=how)
            t_masks, t_hops = t_walk_fn(t_idx, ids[start], rows, collect_hops=how)
            assert sorted(t_masks) == sorted(ids[d] for d in r_masks)
            for d, m in r_masks.items():
                np.testing.assert_array_equal(t_masks[ids[d]].numpy(), m)
            assert [hop_key(h) for h in t_hops] == [hop_key(h, ids) for h in r_hops]
            r_terms, r_th = RQ._attr_propagate(r_idx, start, rows, attrs, direction,
                                               collect_hops=how)
            t_terms, t_th = TQ._attr_propagate(t_idx, ids[start], rows, attrs, direction,
                                               collect_hops=how)
            assert sorted(t_terms) == sorted(ids[d] for d in r_terms)
            for d, terms in r_terms.items():
                assert len(t_terms[ids[d]]) == len(terms)
                for (trm, taw), (rrm, raw) in zip(t_terms[ids[d]], terms):
                    np.testing.assert_array_equal(trm.numpy(), rrm)
                    np.testing.assert_array_equal(taw.numpy().view(np.uint32), raw)
            assert [hop_key(h) for h in t_th] == [hop_key(h, ids) for h in r_th]


@pytest.mark.parametrize("kind", ["identity", "vreduce", "vaugment", "join"])
def test_attr_map_helpers_match_reference(kind):
    """``_attrs_forward`` / ``_attrs_backward`` map every single attribute
    (and a random set) as ``repro``'s do."""
    rng = np.random.default_rng(3)
    bits = rng.random(45) < 0.4
    bits[[0, 44]] = True
    perm = np.where(bits, np.arange(45), -1).astype(np.int32)
    r = RAttrMap(kind, bitset=None if kind == "identity" else RS.Bitset.from_bits(bits),
                 m=20 if kind == "vaugment" else None, perm=perm if kind == "join" else None)
    t = AttrMap(kind, bitset=None if kind == "identity" else TS.Bitset.from_bits(bits),
                m=20 if kind == "vaugment" else None,
                perm=torch.from_numpy(perm) if kind == "join" else None)
    n_in, n_out = {"identity": (45, 45), "vreduce": (45, int(bits.sum())),
                   "vaugment": (20, 45), "join": (45, 45)}[kind]
    masks = [np.eye(n_in, dtype=bool)[i] for i in range(n_in)] + [rng.random(n_in) < 0.3]
    for m in masks:
        np.testing.assert_array_equal(
            TQ._attrs_forward(t, torch.from_numpy(m), n_out).numpy(),
            RQ._attrs_forward(r, m, n_out))
    masks = [np.eye(n_out, dtype=bool)[i] for i in range(n_out)] + [rng.random(n_out) < 0.3]
    for m in masks:
        np.testing.assert_array_equal(
            TQ._attrs_backward(t, torch.from_numpy(m), n_in).numpy(),
            RQ._attrs_backward(r, m, n_in))
