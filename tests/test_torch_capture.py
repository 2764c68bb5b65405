"""Capture in the port against capture in the JAX package.

One op-spec list from ``pipegen.random_specs`` is replayed into both
packages (the port's twin of ``pipegen.apply_spec`` lives here); per op the
capture payload (kept rows, source rows, join pairs), the CSR halves and
the packed bitplanes must be equal exactly, and the tables equal to float32
rounding (rtol=1e-5, atol=1e-5: means and deviations sum in another order).
Dataset ids come from each package's own counter, so datasets are aligned
by op position, never by id.  Each op is also held to ``repro``'s on its
own, and a ``repro`` index carried over with ``index_from_numpy`` must
answer like a port-captured one.
"""
import numpy as np
import pytest
import torch

import pipegen
from repro.core.capture import force_coo_capture as r_force_coo
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import ops as RO
from repro.dataprep import usecases as RU
from repro.dataprep.table import Table as RTable
from repro_torch.core.capture import force_coo_capture
from repro_torch.core.carry import index_from_numpy
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import ops as TO
from repro_torch.dataprep import usecases as TU
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import prov

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port's twin of pipegen's spec replay
# ---------------------------------------------------------------------------
def apply_spec(cur, spec, idx):
    kind = spec[0]
    if kind == "filter":
        mask = cur.table.col("x") > spec[1]
        if not bool(mask.any()):
            mask[0] = True
        return cur.filter_rows(mask)
    if kind == "scale":
        return cur.value_transform("x", "scale", factor=2.0)
    if kind == "oversample":
        return cur.oversample(frac=spec[1], seed=spec[2])
    if kind == "undersample":
        return cur.undersample(frac=spec[1], seed=spec[2])
    if kind == "join":
        r = track(Table.from_columns({c: v.copy() for c, v in spec[1].items()}, device=CPU), idx)
        return cur.join(r, on="k", how=spec[2])
    if kind == "append":
        r = track(Table.from_columns({c: v.copy() for c, v in spec[1].items()}, device=CPU), idx)
        return cur.append(r)
    raise ValueError(kind)


def build_merged(base, specs):
    idx = ProvenanceIndex("merged", device=CPU)
    cur = track(Table.from_columns({c: v.copy() for c, v in base.items()}, device=CPU),
                idx, "src")
    ids = ["src"]
    for spec in specs:
        cur = apply_spec(cur, spec, idx)
        ids.append(cur.dataset_id)
    cur.mark_sink()
    return idx, ids


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _payload(info):
    return [info.kept_rows, info.src_rows, info.join_pairs]


def assert_same_capture(r_idx, t_idx):
    assert len(r_idx.ops) == len(t_idx.ops)
    for ro, to in zip(r_idx.ops, t_idx.ops):
        assert (ro.info.op_name, ro.info.category.value, ro.info.contextual) == \
            (to.info.op_name, to.info.category.value, to.info.contextual)
        assert (ro.tensor.n_out, ro.tensor.n_in, ro.tensor.nnz) == \
            (to.tensor.n_out, to.tensor.n_in, to.tensor.nnz)
        for r, t in zip(_payload(ro.info), _payload(to.info)):
            assert (r is None) == (t is None)
            if r is not None:
                assert t.dtype == torch.int32
                np.testing.assert_array_equal(t.numpy(), r)
        for k in range(ro.tensor.k):
            for half in ("fwd", "bwd"):
                rc, tc = getattr(ro.tensor, half)(k), getattr(to.tensor, half)(k)
                np.testing.assert_array_equal(tc.row_ptr.numpy(), rc.row_ptr)
                np.testing.assert_array_equal(tc.col_idx.numpy(), rc.col_idx)
            np.testing.assert_array_equal(_u32(to.tensor.bitplane_fwd(k)),
                                          ro.tensor.bitplane_fwd(k))
            np.testing.assert_array_equal(_u32(to.tensor.bitplane_bwd(k)),
                                          ro.tensor.bitplane_bwd(k))
        assert to.tensor.nbytes() == ro.tensor.nbytes()
        r_ds, t_ds = r_idx.datasets[ro.output_id], t_idx.datasets[to.output_id]
        assert (r_ds.n_rows, r_ds.n_cols, r_ds.columns) == (t_ds.n_rows, t_ds.n_cols, t_ds.columns)


@pytest.mark.parametrize("seed", range(10))
def test_random_specs_capture_identically(seed):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    assert_same_capture(r_idx, t_idx)
    r_sink, t_sink = r_idx.datasets[r_ids[-1]].table, t_idx.datasets[t_ids[-1]].table
    np.testing.assert_allclose(t_sink.data.numpy(), r_sink.data, **TOL)
    np.testing.assert_array_equal(t_sink.null.numpy(), r_sink.null)
    np.testing.assert_array_equal(t_sink.index.numpy(), r_sink.index)


def test_forced_coo_capture_matches_reference():
    base, specs = pipegen.random_specs(3)
    with r_force_coo():
        r_idx, _ = pipegen.build_merged(base, specs)
    with force_coo_capture():
        t_idx, _ = build_merged(base, specs)
    assert not any(op.tensor.structured for op in t_idx.ops)
    assert_same_capture(r_idx, t_idx)
    for ro, to in zip(r_idx.ops, t_idx.ops):
        np.testing.assert_array_equal(to.tensor.coo.numpy(), ro.tensor.coo)


def test_german_captures_same_nnz_and_bytes():
    r_idx = RIndex("german")
    r_sink = RU.run_german(r_idx, RU.make_german())
    t_idx = ProvenanceIndex("german", device=CPU)
    t_sink = TU.run_german(t_idx, TU.make_german(device=CPU))
    assert [op.tensor.nnz for op in t_idx.ops] == [op.tensor.nnz for op in r_idx.ops]
    assert [op.tensor.nbytes() for op in t_idx.ops] == [op.tensor.nbytes() for op in r_idx.ops]
    assert t_idx.prov_nbytes() == r_idx.prov_nbytes()
    np.testing.assert_allclose(t_sink.table.data.numpy(), r_sink.table.data, **TOL)
    assert_same_capture(r_idx, t_idx)


def test_compas_filter_and_quantile_bins_match_reference():
    r_idx = RIndex("compas")
    r_sink = RU.run_compas(r_idx, RU.make_compas())
    t_idx = ProvenanceIndex("compas", device=CPU)
    t_sink = TU.run_compas(t_idx, TU.make_compas(device=CPU))
    np.testing.assert_array_equal(t_idx.ops[1].info.kept_rows.numpy(), r_idx.ops[1].info.kept_rows)
    assert t_idx.ops[4].info.params["edges"] == r_idx.ops[4].info.params["edges"]
    assert t_idx.ops[0].info.params["fills"] == r_idx.ops[0].info.params["fills"]
    np.testing.assert_allclose(t_sink.table.data.numpy(), r_sink.table.data, **TOL)


# ---------------------------------------------------------------------------
# each op on its own
# ---------------------------------------------------------------------------
def _tables(seed, n=40):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 9, n).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32),
        "g": rng.integers(0, 4, n).astype(np.float32),
        "y": np.round(rng.normal(size=n), 1).astype(np.float32),
    }
    nulls = {"x": rng.random(n) < 0.2, "y": rng.random(n) < 0.2, "g": rng.random(n) < 0.1}
    return RTable.from_columns(cols, null=nulls), Table.from_columns(cols, null=nulls, device=CPU)


def _right_tables(seed, m=12):
    rng = np.random.default_rng(seed + 99)
    cols = {"k": rng.integers(0, 12, m).astype(np.float32),
            "z": rng.normal(size=m).astype(np.float32),
            "x": rng.normal(size=m).astype(np.float32)}
    return RTable.from_columns(cols), Table.from_columns(cols, device=CPU)


def _same_result(r_res, t_res):
    (rt, ri), (tt, ti) = r_res, t_res
    assert tt.columns == rt.columns
    np.testing.assert_allclose(tt.data.numpy(), rt.data, **TOL)
    np.testing.assert_array_equal(tt.null.numpy(), rt.null)
    np.testing.assert_array_equal(tt.index.numpy(), rt.index)
    assert (ti.op_name, ti.category.value, ti.contextual, ti.n_out, list(ti.n_in)) == \
        (ri.op_name, ri.category.value, ri.contextual, int(ri.n_out), list(ri.n_in))
    for r, t in zip(_payload(ri), _payload(ti)):
        assert (r is None) == (t is None)
        if r is not None:
            np.testing.assert_array_equal(t.numpy(), r)
    for ra, ta in zip(ri.attr_maps, ti.attr_maps):
        assert ra.kind == ta.kind and ra.m == ta.m
        if ra.bitset is not None:
            np.testing.assert_array_equal(_u32(ta.bitset.words), ra.bitset.words)
        if ra.perm is not None:
            np.testing.assert_array_equal(ta.perm.numpy(), ra.perm)


OPS = {
    "log1p": lambda P, t: P.value_transform(t, "x", "log1p"),
    "clip": lambda P, t: P.value_transform(t, "x", "clip", lo=-0.5, hi=0.5),
    "binarize": lambda P, t: P.binarize(t, "x", 0.1),
    "zscore": lambda P, t: P.normalize(t, ["x", "y"], "zscore"),
    "minmax": lambda P, t: P.normalize(t, ["x"], "minmax"),
    "mean": lambda P, t: P.impute(t, ["x", "y"], "mean"),
    "median": lambda P, t: P.impute(t, ["x", "y"], "median"),
    "mode": lambda P, t: P.impute(t, ["y", "g"], "mode"),
    "uniform": lambda P, t: P.discretize(t, "k", 3, "uniform"),
    "quantile": lambda P, t: P.discretize(t, "x", 4, "quantile"),
    "select": lambda P, t: P.select_columns(t, ["g", "k"]),
    "drop": lambda P, t: P.drop_columns(t, ["y"]),
    "filter": lambda P, t: P.filter_rows(t, np.arange(t.n_rows) % 3 != 1),
    "undersample": lambda P, t: P.undersample(t, 0.6, seed=5),
    "onehot": lambda P, t: P.onehot(t, "g"),
    "string_indexer": lambda P, t: P.string_indexer(t, "k"),
    "space": lambda P, t: P.space_transform(t, ["x", "k"], np.eye(2, 3, dtype=np.float32)),
    "oversample": lambda P, t: P.oversample(t, 0.5, seed=3, noise=0.1),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_single_op_matches_reference(name):
    r_t, t_t = _tables(sum(map(ord, name)))
    _same_result(OPS[name](RO, r_t), OPS[name](TO, t_t))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_pair_order_matches_reference(how):
    """Stable sort + left/right searchsorted + repeat: the same pairs in the
    same order, outer-join dangling rows included."""
    r_l, t_l = _tables(7)
    r_r, t_r = _right_tables(7)
    _same_result(RO.join(r_l, r_r, "k", how), TO.join(t_l, t_r, "k", how))
    _same_result(RO.join(r_l, r_r, "k", how, max_pairs=10),
                 TO.join(t_l, t_r, "k", how, max_pairs=10))


def test_append_matches_reference():
    r_l, t_l = _tables(8)
    r_r, t_r = _right_tables(8)
    _same_result(RO.append(r_l, r_r), TO.append(t_l, t_r))


def test_duplicate_groups_match_reference():
    rng = np.random.default_rng(2)
    cols = {"a": rng.integers(0, 3, 30).astype(np.float32),
            "b": rng.integers(0, 2, 30).astype(np.float32)}
    nulls = {"a": rng.random(30) < 0.2}
    r = RTable.from_columns(cols, null=nulls)
    t = Table.from_columns(cols, null=nulls, device=CPU)
    np.testing.assert_array_equal(t.duplicate_groups().numpy(), r.duplicate_groups())


# ---------------------------------------------------------------------------
# carrying a reference index across
# ---------------------------------------------------------------------------
def test_index_from_numpy_answers_like_port_capture():
    base, specs = pipegen.random_specs(5)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    datasets = [{"id": d, "n_rows": r.n_rows, "n_cols": r.n_cols, "columns": r.columns,
                 "is_source": r.is_source, "is_sink": r.is_sink}
                for d, r in r_idx.datasets.items()]
    ops = [{"op_name": op.info.op_name, "category": op.info.category.value,
            "contextual": op.info.contextual, "input_ids": op.input_ids,
            "output_id": op.output_id, "payload": op.tensor.to_payload()}
           for op in r_idx.ops]
    carried = index_from_numpy(datasets, ops, device=CPU)
    assert carried.device == torch.device("cpu") and len(carried.ops) == len(t_idx.ops)
    assert carried.sources() == r_idx.sources() and carried.sinks() == r_idx.sinks()
    rng = np.random.default_rng(0)
    n_src, n_dst = r_idx.datasets["src"].n_rows, r_idx.datasets[r_ids[-1]].n_rows
    fwd = [sorted(set(rng.integers(0, n_src, 4).tolist())) for _ in range(5)]
    bwd = [sorted(set(rng.integers(0, n_dst, 4).tolist())) for _ in range(5)]
    for walk in (True, False):
        got = prov(carried).source("src").rows_batch(fwd).forward().to(r_ids[-1]).run()
        want = prov(t_idx).source("src").rows_batch(fwd).forward().to(t_ids[-1]).run()
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        got = prov(carried).source(r_ids[-1]).rows_batch(bwd).backward().to("src").run()
        want = prov(t_idx).source(t_ids[-1]).rows_batch(bwd).backward().to("src").run()
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    trans = prov(carried).source(r_ids[-1]).transformations().run()
    assert [r["op"] for r in trans] == [op.info.op_name for op in r_idx.ops]


def test_index_from_numpy_rejects_inconsistent_rows():
    datasets = [{"id": "a", "n_rows": 3, "n_cols": 1, "columns": ["x"]},
                {"id": "b", "n_rows": 2, "n_cols": 1, "columns": ["x"]}]
    ops = [{"op_name": "filter", "category": "horizontal_reduction", "contextual": False,
            "input_ids": ["a"], "output_id": "b",
            "payload": ({"n_out": 2, "n_in": [4], "slots": [{"kind": "gather"}]},
                        {"slot0": np.array([0, 2], np.int32)})}]
    with pytest.raises(ValueError, match="rows"):
        index_from_numpy(datasets, ops, device=CPU)


def test_index_rejects_tables_on_another_device():
    idx = ProvenanceIndex("x", device=CPU)
    t = Table.from_columns({"a": np.zeros(3, np.float32)}, device="meta")
    with pytest.raises(ValueError, match="lies on"):
        track(t, idx)
    with pytest.raises(NotImplementedError, match="A7"):
        ProvenanceIndex("y", device=CPU, spill=True)
    with pytest.raises(NotImplementedError, match="A5"):
        idx.composed()
