"""The port's row-sharded index against ``repro``'s, on the same op specs.

Twins of ``tests/test_sharded_parity.py``: every pipeline is replayed from
``pipegen.random_specs`` (or the diamond) into both packages, viewed as a
``ShardedProvenanceIndex`` at 1, 2, 4 and 8 shards (and uneven and
single-row layouts), and every answer must equal ``repro``'s merged and
sharded answers exactly: raw mask stacks (hop-cache and walk sessions,
the fused walk's plain version included), co-queries and how-traces, cells,
the cross-shard diamond, empty probes, ``-1`` sentinels, ``shard_ranges``,
the catalog seam (cold segments and the hot stitched route), the sharded
hop-cache's ``stats()`` bytes and block kinds, and its reassembled
relation.  Pipelines captured in COO form drive the dense and the composed
CSR blocks.  Plus the ``slice_rows`` edge cases of ``tests/test_spill.py``
and the Hypothesis properties with bounded examples.  Tolerance 0: every
compared value is an integer or a boolean.
"""
import contextlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import pipegen
from repro.core.capture import force_coo_capture as r_force_coo
from repro.core.costmodel import RelStats as RRelStats
from repro.core.provtensor import ProvTensor as RProvTensor
from repro.core.provtensor import append_tensor as r_append
from repro.core.provtensor import haugment_tensor as r_haugment
from repro.core.provtensor import hreduce_tensor as r_hreduce
from repro.core.provtensor import identity_tensor as r_identity
from repro.core.provtensor import join_tensor as r_join
from repro.core.provtensor import shard_ranges as r_shard_ranges
from repro.provenance import ShardedProvenanceIndex as RSharded
from repro.provenance import prov as rprov
from repro_torch.core.capture import force_coo_capture
from repro_torch.core.costmodel import RelStats
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import (
    ProvTensor,
    SlotGather,
    append_tensor,
    haugment_tensor,
    hreduce_tensor,
    identity_tensor,
    join_tensor,
    shard_ranges,
)
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import (
    QuerySession,
    ShardedComposedIndex,
    ShardedProvenanceIndex,
    ShardedTensor,
    prov,
)
from test_torch_capture import build_merged
from test_torch_query import id_map

CPU = "cpu"
SHARD_COUNTS = [1, 2, 4, 8]
SEEDS = list(range(8))


def _eq(got, want):
    """A port tensor (or list of them) equals ``repro``'s numpy answer."""
    if isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _worlds(seed, coo=False):
    """The same spec list built into both packages: (repro index, port
    index, repro -> port dataset ids, repro sink)."""
    base, specs = pipegen.random_specs(seed)
    if coo:
        with r_force_coo():
            r_idx, r_ids = pipegen.build_merged(base, specs)
        with force_coo_capture():
            t_idx, _ = build_merged(base, specs)
    else:
        r_idx, r_ids = pipegen.build_merged(base, specs)
        t_idx, _ = build_merged(base, specs)
    return r_idx, t_idx, id_map(r_idx, t_idx), r_ids[-1]


def _diamond(seed, coo=False):
    """``pipegen.diamond_pipeline`` in both packages."""
    if coo:
        with r_force_coo():
            r_idx, r_sink = pipegen.diamond_pipeline(seed, name="sharddia")
    else:
        r_idx, r_sink = pipegen.diamond_pipeline(seed, name="sharddia")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 20))
    t_idx = ProvenanceIndex(f"sharddia{seed}", device=CPU)
    with force_coo_capture() if coo else contextlib.nullcontext():
        s = track(Table.from_columns({"k": np.arange(n, dtype=np.float32),
                                      "x": rng.normal(size=n).astype(np.float32)}, device=CPU),
                  t_idx, "src")
        a = s.filter_rows(torch.from_numpy(rng.random(n) < 0.75))
        b = s.value_transform("x", "scale", factor=2.0)
        a.join(b, on="k", how="inner").mark_sink()
    return r_idx, t_idx, id_map(r_idx, t_idx), r_sink


def _stats(composed):
    out = dict(composed.stats())
    out.pop("index")
    return out


# ===========================================================================
# Seeded differential sweep
# ===========================================================================
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_record_mask_stack_parity(seed, n_shards):
    """Raw (B, n) mask stacks — forward and backward, hop-cache, walk and
    fused walk — equal the merged engine's; the sharded hop-cache's stats
    (bytes, block kinds, hits) equal ``repro``'s."""
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    sink = ids[r_sink]
    rng = np.random.default_rng(seed)
    fwd = pipegen.row_probes(rng, r_idx.datasets["src"].n_rows) + [[]]
    bwd = pipegen.row_probes(rng, r_idx.datasets[r_sink].n_rows)
    merged = r_idx.session()
    want_f = merged.run_masks(rprov(r_idx).source("src").rows_batch(fwd).forward()
                              .to(r_sink).plan())
    want_b = merged.run_masks(rprov(r_idx).source(r_sink).rows_batch(bwd).backward()
                              .to("src").plan())
    rv = RSharded(r_idx, n_shards, engine="numpy")
    rs = rv.session()
    rs.run_masks(rprov(rv).source("src").rows_batch(fwd).forward().to(r_sink).plan())
    rs.run_masks(rprov(rv).source(r_sink).rows_batch(bwd).backward().to("src").plan())
    sv = ShardedProvenanceIndex(t_idx, n_shards, engine="numpy")
    sessions = [sv.session(), QuerySession(sv, use_hopcache=False),
                QuerySession(sv, use_hopcache=False, fused_walk=True)]
    for ss in sessions:
        _eq(ss.run_masks(prov(sv).source("src").rows_batch(fwd).forward().to(sink).plan()),
            want_f)
        _eq(ss.run_masks(prov(sv).source(sink).rows_batch(bwd).backward().to("src").plan()),
            want_b)
    assert _stats(sv.composed()) == _stats(rv.composed())
    assert sv.stats()["n_shards"] == n_shards


@pytest.mark.parametrize("n_shards", [3, 5, 7])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uneven_shard_counts(seed, n_shards):
    """Shard counts that do NOT divide n: every range boundary still
    concatenates exactly, for every dataset reached from the source."""
    r_idx, t_idx, ids, _ = _worlds(seed)
    rng = np.random.default_rng(seed + 100)
    merged = r_idx.session()
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    for dst in r_idx.datasets:
        rows = pipegen.row_probes(rng, r_idx.datasets["src"].n_rows)
        want = merged.run_masks(rprov(r_idx).source("src").rows_batch(rows).forward()
                                .to(dst).plan())
        _eq(sv.session().run_masks(prov(sv).source("src").rows_batch(rows).forward()
                                   .to(ids[dst]).plan()), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_single_row_shards(seed):
    """n_shards == n_rows of the sink: every shard holds at most one row."""
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    rng = np.random.default_rng(seed)
    n_sink = r_idx.datasets[r_sink].n_rows
    rows = pipegen.row_probes(rng, r_idx.datasets["src"].n_rows)
    want = r_idx.session().run_masks(rprov(r_idx).source("src").rows_batch(rows).forward()
                                     .to(r_sink).plan())
    sv = ShardedProvenanceIndex(t_idx, n_sink)
    _eq(sv.session().run_masks(prov(sv).source("src").rows_batch(rows).forward()
                               .to(ids[r_sink]).plan()), want)
    # and backward, where every shard scatters its single row
    bwd = pipegen.row_probes(rng, n_sink)
    want = r_idx.session().run_masks(rprov(r_idx).source(r_sink).rows_batch(bwd).backward()
                                     .to("src").plan())
    _eq(sv.session().run_masks(prov(sv).source(ids[r_sink]).rows_batch(bwd).backward()
                               .to("src").plan()), want)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_co_queries_and_how_parity(seed, n_shards):
    """Co-contributory / co-dependency / how traces through the sharded
    session equal ``repro``'s sharded session's."""
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    rng = np.random.default_rng(seed)
    n_src = r_idx.datasets["src"].n_rows
    mids = [d for d in r_idx.datasets
            if d not in ("src", r_sink) and r_idx.path_exists("src", d)
            and r_idx.path_exists(d, r_sink)]
    rv = RSharded(r_idx, n_shards, engine="numpy")
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    rs, ss = rv.session(), sv.session()
    sink = ids[r_sink]
    rows = [int(rng.integers(0, n_src))]
    for d2 in mids[:2]:
        _eq(ss.run(prov(sv).source("src").rows(rows).co_contributory(ids[d2], via=sink).plan()),
            rs.run(rprov(rv).source("src").rows(rows).co_contributory(d2, via=r_sink).plan()))
    for mid in mids[:2]:
        mrows = [int(rng.integers(0, r_idx.datasets[mid].n_rows))]
        _eq(ss.run(prov(sv).source(ids[mid]).rows(mrows).co_dependency("src", sink).plan()),
            rs.run(rprov(rv).source(mid).rows(mrows).co_dependency("src", r_sink).plan()))
    t_recs, t_hops = ss.run(prov(sv).source(sink).rows([0]).backward().to("src").how().plan())
    r_recs, r_hops = rs.run(rprov(rv).source(r_sink).rows([0]).backward().to("src").how()
                            .plan())
    _eq(t_recs, r_recs)
    assert [(h.op_id, h.op_name, h.n_records) for h in t_hops] == \
        [(h.op_id, h.op_name, h.n_records) for h in r_hops]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_cells_parity(seed, n_shards):
    """Cell-level lineage through the sharded view (attribute maps are
    shared with the base index)."""
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    rng = np.random.default_rng(seed)
    rows = [int(rng.integers(0, r_idx.datasets[r_sink].n_rows))]
    rv = RSharded(r_idx, n_shards, engine="numpy")
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    _eq(sv.session().run(prov(sv).source(ids[r_sink]).rows(rows).attrs([0]).backward()
                         .to("src").plan()),
        rv.session().run(rprov(rv).source(r_sink).rows(rows).attrs([0]).backward()
                         .to("src").plan()))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_cross_shard_diamond(seed, n_shards):
    """The multi-producer diamond: sharded answers and hop-cache stats equal
    ``repro``'s sharded view's, and its answers the merged walk's."""
    r_idx, t_idx, ids, r_sink = _diamond(seed)
    sink = ids[r_sink]
    n_src = r_idx.datasets["src"].n_rows
    n_sink = r_idx.datasets[r_sink].n_rows
    rv = RSharded(r_idx, n_shards, engine="numpy")
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    rs, ss = rv.session(), sv.session()
    merged = r_idx.session()
    for rows in ([], [0], [n_src - 1], list(range(n_src))):
        got = ss.run(prov(sv).source("src").rows(rows).forward().to(sink).plan())
        _eq(got, rs.run(rprov(rv).source("src").rows(rows).forward().to(r_sink).plan()))
        _eq(got, merged.run(rprov(r_idx).source("src").rows(rows).forward().to(r_sink).plan()))
    for rows in ([], [0], list(range(n_sink))):
        want = rs.run(rprov(rv).source(r_sink).rows(rows).backward().to("src").plan())
        _eq(ss.run(prov(sv).source(sink).rows(rows).backward().to("src").plan()), want)
    assert _stats(sv.composed()) == _stats(rv.composed())


def test_empty_probes_and_no_path():
    _, t_idx, ids, r_sink = _worlds(0)
    sv = ShardedProvenanceIndex(t_idx, 4, engine="numpy")
    ss = sv.session()
    assert ss.run(prov(sv).source(ids[r_sink]).rows_batch([]).backward().to("src").plan()) == []
    # no dataflow path: all-empty, never an error (the walkers' convention)
    got = ss.run(prov(sv).source(ids[r_sink]).rows([0]).forward().to("src").plan())
    assert got.numel() == 0
    assert ss.explain(prov(sv).source("src").rows([0]).forward().to(ids[r_sink]).plan())


def test_sentinel_slices():
    """-1 sentinels (outer join null side) survive row slicing; a COO
    tensor's slices concatenate to its forward masks."""
    src = np.array([0, -1, 2, -1, 1], dtype=np.int32)
    t = ProvTensor(n_out=5, n_in=(3,), slots=[SlotGather(torch.from_numpy(src))])
    for lo, hi in shard_ranges(5, 3):
        np.testing.assert_array_equal(t.slice_rows(lo, hi).slot_gather(0).numpy(), src[lo:hi])
    coo = np.array([[0, 0], [2, 2], [4, 1]], dtype=np.int32)
    tc = ProvTensor(n_out=5, n_in=(3,), coo=torch.from_numpy(coo))
    rc = RProvTensor(n_out=5, n_in=(3,), coo=coo)
    masks = np.eye(3, dtype=bool)
    for n_shards in (2, 3, 5):
        parts = [tc.slice_rows(lo, hi) for lo, hi in shard_ranges(5, n_shards)]
        got = torch.cat([s.forward_mask_batch(0, torch.from_numpy(masks)) for s in parts], dim=1)
        _eq(got, rc.forward_mask_batch(0, masks))
        st_ = ShardedTensor(tc, n_shards)
        _eq(st_.forward_mask_batch(0, torch.from_numpy(masks)), rc.forward_mask_batch(0, masks))
        _eq(st_.backward_mask_batch(0, torch.from_numpy(np.eye(5, dtype=bool))),
            rc.backward_mask_batch(0, np.eye(5, dtype=bool)))


@pytest.mark.parametrize("n,s", [(10, 4), (3, 8), (0, 2), (7, 1), (100, 7), (5, 5)])
def test_shard_ranges_layout(n, s):
    assert shard_ranges(n, s) == r_shard_ranges(n, s)
    assert shard_ranges(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    with pytest.raises(ValueError):
        shard_ranges(5, 0)


def test_collective_engine_raises():
    """Without a process group of 2 ranks the collective engine raises, as
    ``repro``'s does without 2 devices (``tests/test_torch_collective.py``
    runs it on gloo)."""
    _, t_idx, _, _ = _worlds(0)
    with pytest.raises(RuntimeError, match="process group"):
        ShardedProvenanceIndex(t_idx, 2, engine="collective")
    with pytest.raises(ValueError):
        ShardedProvenanceIndex(t_idx, 2, engine="mesh")
    with pytest.raises(ValueError):
        ShardedProvenanceIndex(t_idx, 0)


# ===========================================================================
# Blocks of every kind: COO capture drives the dense and composed CSR blocks
# ===========================================================================
def _relation_rows(rel):
    """Row sets of a CSR relation (scipy or torch sparse)."""
    if isinstance(rel, torch.Tensor):
        crow, col = rel.crow_indices().numpy(), rel.col_indices().numpy()
    else:
        crow, col = rel.indptr, rel.indices
    return [sorted(col[crow[i]: crow[i + 1]].tolist()) for i in range(len(crow) - 1)]


COO_WORLDS = [("specs", s) for s in SEEDS] + [("diamond", s) for s in range(4)]


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("world,seed", COO_WORLDS)
def test_coo_capture_blocks_and_relation(world, seed, n_shards):
    """Unstructured chains compose per shard (dense blocks where the shard's
    estimated density reaches the threshold, CSR products elsewhere): block
    kinds, bytes, probes and the reassembled relation equal ``repro``'s."""
    make = _worlds if world == "specs" else _diamond
    r_idx, t_idx, ids, r_sink = make(seed, coo=True)
    sink = ids[r_sink]
    rv = RSharded(r_idx, n_shards, engine="numpy")
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    rc, tc = rv.composed(), sv.composed()
    n_src = r_idx.datasets["src"].n_rows
    n_sink = r_idx.datasets[r_sink].n_rows
    rng = np.random.default_rng(seed)
    fwd = np.zeros((3, n_src), dtype=bool)
    fwd[0, rng.integers(0, n_src, 4)] = True
    fwd[2] = True
    bwd = np.zeros((3, n_sink), dtype=bool)
    bwd[1, rng.integers(0, n_sink, 3)] = True
    bwd[2] = True
    for d in [r_sink] + [o.output_id for o in r_idx.ops[:2]]:
        _eq(tc.probe_forward(torch.from_numpy(fwd), "src", ids[d]),
            rc.probe_forward(fwd, "src", d))
    _eq(tc.probe_backward(torch.from_numpy(bwd), sink, "src"), rc.probe_backward(bwd, r_sink, "src"))
    assert _relation_rows(tc.relation_csr("src", sink)) == \
        _relation_rows(rc.relation_csr("src", r_sink))
    assert _stats(tc) == _stats(rc)
    entry = tc._entry("src", sink)
    for b in entry.blocks:
        if b.kind == "csr":
            assert b.mat.crow_indices().dtype == torch.int32
            assert b.mat.col_indices().dtype == torch.int32
        else:
            assert b.mat.dtype == torch.bool


def test_coo_capture_reaches_dense_and_csr_blocks():
    kinds = set()
    for world, seed in COO_WORLDS:
        make = _worlds if world == "specs" else _diamond
        _, t_idx, ids, r_sink = make(seed, coo=True)
        sv = ShardedProvenanceIndex(t_idx, 2)
        kinds |= {b.kind for b in sv.composed()._entry("src", ids[r_sink]).blocks}
    assert kinds == {"csr", "dense"}


def test_sharded_tensor_rows_match_reference():
    r_idx, t_idx, ids, _ = _worlds(1)
    for r_op, t_op in zip(r_idx.ops, t_idx.ops):
        for n_shards in (1, 3):
            rt = RSharded(r_idx, n_shards, engine="numpy").ops[r_op.op_id].tensor
            tt = ShardedProvenanceIndex(t_idx, n_shards).ops[t_op.op_id].tensor
            for k in range(tt.k):
                for rows in ([0], [1, 2, -1]):
                    _eq(tt.backward_rows(k, rows), rt.backward_rows(k, rows))
                rows_in = [0, t_op.tensor.n_in[k] - 1]
                _eq(tt.forward_rows(k, rows_in), rt.forward_rows(k, rows_in))
                assert tt.slot_nnz_range(k, 1, 5) == rt.slot_nnz_range(k, 1, 5)
                got, want = RelStats.from_slot_range(tt, k, 2, 9), \
                    RRelStats.from_slot_range(rt, k, 2, 9)
                assert (got.rows, got.cols, got.nnz, got.structured) == \
                    (want.rows, want.cols, want.nnz, want.structured)


# ===========================================================================
# The federation seam: shards as catalog members
# ===========================================================================
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_catalog_seam_parity(seed, n_shards):
    """Cross-shard probes through the federation: identity fan-out links,
    per-shard relation ops, range-alignment gather links — cold segment
    path AND hot stitched route — equal the merged engine's answers."""
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    sink = ids[r_sink]
    rng = np.random.default_rng(seed)
    fwd = pipegen.row_probes(rng, r_idx.datasets["src"].n_rows) + [[]]
    bwd = pipegen.row_probes(rng, r_idx.datasets[r_sink].n_rows)
    merged = r_idx.session()
    want_f = merged.run(rprov(r_idx).source("src").rows_batch(fwd).forward().to(r_sink).plan())
    want_b = merged.run(rprov(r_idx).source(r_sink).rows_batch(bwd).backward().to("src").plan())
    sv = ShardedProvenanceIndex(t_idx, n_shards, engine="numpy")
    catalog = sv.as_catalog("src", sink)
    assert sorted(catalog.members) == sorted(
        ["root", "gather"] + [f"shard{s}" for s in range(n_shards)])
    fs = catalog.session()
    fplan = prov(catalog).source("root/src").rows_batch(fwd).forward().to(f"gather/{sink}").plan()
    bplan = prov(catalog).source(f"gather/{sink}").rows_batch(bwd).backward().to("root/src").plan()
    _eq(fs.run(fplan), want_f)
    _eq(fs.run(bplan), want_b)
    for _ in range(12):     # past the cross gate's demand: the hot route
        hot_f, hot_b = fs.run(fplan), fs.run(bplan)
    _eq(hot_f, want_f)
    _eq(hot_b, want_b)
    assert fs.counters["cross_composes"] >= 1


def test_catalog_seam_diamond():
    r_idx, t_idx, ids, r_sink = _diamond(1)
    sv = ShardedProvenanceIndex(t_idx, 4, engine="numpy")
    catalog = sv.as_catalog("src", ids[r_sink])
    n_src = r_idx.datasets["src"].n_rows
    probes = [[], [0], list(range(n_src))]
    want = r_idx.session().run(rprov(r_idx).source("src").rows_batch(probes).forward()
                               .to(r_sink).plan())
    got = catalog.session().run(prov(catalog).source("root/src").rows_batch(probes).forward()
                                .to(f"gather/{ids[r_sink]}").plan())
    _eq(got, want)


# ===========================================================================
# slice_rows edge cases (the shard-construction primitive)
# ===========================================================================
def _tensor_kinds():
    """``tests/test_spill.py::_tensor_kinds`` in both packages."""
    rng = np.random.default_rng(7)
    kept = np.sort(rng.choice(40, size=25, replace=False)).astype(np.int32)
    src = rng.integers(-1, 40, size=30).astype(np.int32)
    pairs = np.stack([rng.integers(-1, 12, 20), rng.integers(-1, 9, 20)], axis=1).astype(np.int32)
    pairs[(pairs[:, 0] < 0) & (pairs[:, 1] < 0), 0] = 0
    links = np.stack([np.repeat(np.arange(10), 2), rng.integers(0, 33, 20)],
                     axis=1).astype(np.int32)
    t = torch.from_numpy
    return {
        "identity": (identity_tensor(17, device=CPU), r_identity(17)),
        "hreduce": (hreduce_tensor(t(kept), 40), r_hreduce(kept, 40)),
        "haugment": (haugment_tensor(t(src), 40), r_haugment(src, 40)),
        "join": (join_tensor(t(pairs), 12, 9), r_join(pairs, 12, 9)),
        "append": (append_tensor(11, 6, device=CPU), r_append(11, 6)),
        "coo_links": (ProvTensor(n_out=10, n_in=(33,), coo=t(links)),
                      RProvTensor(n_out=10, n_in=(33,), coo=links)),
    }


@pytest.mark.parametrize("kind", list(_tensor_kinds()))
def test_slice_rows_matches_reference(kind):
    """Every window (empty, single-row, straddling, whole): the same
    regime, gathers, COO, nnz and bytes as ``repro``'s slice."""
    tt, rt = _tensor_kinds()[kind]
    n = tt.n_out
    windows = [(0, 0), (n // 2, n // 2), (0, 1), (n - 1, n), (n // 3, 2 * n // 3),
               (0, n), (2, n + 5)]
    for lo, hi in windows:
        ts, rs = tt.slice_rows(lo, hi), rt.slice_rows(lo, hi)
        assert (ts.n_out, ts.n_in, ts.structured) == (rs.n_out, rs.n_in, rs.structured)
        for k in range(tt.k):
            assert ts.slot_nnz(k) == rs.slot_nnz(k)
            assert tt.slot_nnz_range(k, lo, hi) == rt.slot_nnz_range(k, lo, hi)
            if rs.structured:
                _eq(ts.slot_gather(k), rs.slot_gather(k))
        assert ts.nbytes(include_index=False) == rs.nbytes(include_index=False)
        _eq(ts.coo, rs.coo)


def test_slice_rows_edges():
    kinds = _tensor_kinds()
    for tt, _ in kinds.values():
        lo = tt.n_out // 2
        s = tt.slice_rows(lo, lo)
        assert s.n_out == 0 and s.coo.shape[0] == 0 and s.n_in == tt.n_in
    with pytest.raises(ValueError):
        identity_tensor(10, device=CPU).slice_rows(5, 3)
    # a slice landing entirely on -1 sentinel rows: zero nnz, empty mirrors
    src = np.full(8, -1, dtype=np.int32)
    src[:2] = [3, 1]
    s = haugment_tensor(torch.from_numpy(src), 10).slice_rows(2, 8)
    assert s.n_out == 6 and s.slot_nnz(0) == 0
    assert int(s.fwd(0).row_ptr[-1]) == 0
    assert bool((s.slot_gather(0) == -1).all())
    # a gather slot's slice is a view of its payload, no copy
    g = torch.from_numpy(src)
    sl = haugment_tensor(g, 10).slice_rows(2, 6)
    assert sl.slot_gather(0).data_ptr() == g.data_ptr() + 2 * 4
    # single rows of append blocks, and a slice straddling the boundary
    t = append_tensor(5, 3, device=CPU)
    for r in (0, 4, 5, 7):
        coo = t.slice_rows(r, r + 1).coo
        assert coo.shape[0] == 1 and int(coo[0, 0]) == 0
        assert coo[0, 1:].tolist() == ([r, -1] if r < 5 else [-1, r - 5])
    np.testing.assert_array_equal(t.slice_rows(4, 6).coo[:, 1:].numpy(), t.coo[4:6, 1:].numpy())


# ===========================================================================
# Hypothesis properties (free seed x shards x probes, minimized on failure)
# ===========================================================================
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n_shards=st.integers(1, 12), data=st.data())
def test_prop_record_parity(seed, n_shards, data):
    r_idx, t_idx, ids, r_sink = _worlds(seed)
    n_src = r_idx.datasets["src"].n_rows
    probes = data.draw(st.lists(st.lists(st.integers(0, n_src - 1), max_size=6), max_size=4))
    want = r_idx.session().run_masks(rprov(r_idx).source("src").rows_batch(probes).forward()
                                     .to(r_sink).plan())
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    _eq(sv.session().run_masks(prov(sv).source("src").rows_batch(probes).forward()
                               .to(ids[r_sink]).plan()), want)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), n_shards=st.integers(2, 10))
def test_prop_diamond_backward_parity(seed, n_shards):
    r_idx, t_idx, ids, r_sink = _diamond(seed % 50)
    n_sink = r_idx.datasets[r_sink].n_rows
    probes = [[], [0], list(range(n_sink))]
    want = r_idx.session().run_masks(rprov(r_idx).source(r_sink).rows_batch(probes).backward()
                                     .to("src").plan())
    sv = ShardedProvenanceIndex(t_idx, n_shards)
    _eq(sv.session().run_masks(prov(sv).source(ids[r_sink]).rows_batch(probes).backward()
                               .to("src").plan()), want)
    assert isinstance(sv.composed(), ShardedComposedIndex)
