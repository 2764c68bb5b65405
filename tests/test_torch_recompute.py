"""The port's per-record recomputation (``core/recompute.py``) and its
values plans, against the JAX package's, on the CPU.

Every world is built in both packages from the same numpy columns;
datasets are aligned by the order they were made in, never by id.  Held
bit for bit (data bits, null flags, index, columns):

* ``recompute_rows`` on each dataset's sorted distinct rows, and
  ``fetch_rows`` on duplicated rows in shuffled order, against ``repro``'s;
* a ``.values()`` plan's rows against ``repro``'s Q1 (forward from the
  source) and Q2 (backward from the sink) to the same target, and its
  values against ``repro``'s ``recompute_rows`` of those rows.

The worlds: ``pipegen.random_specs`` lists (filters, scaling, over- and
undersampling, inner and outer joins, appends); joins at every ``how``
whose keys hold NaN of either sign and signed zeros, with each input kept
or recomputed; oversampling with noise; contextual ops (impute, z-score
and min-max normalization, discretization) whose inputs the policy keeps,
at values whose statistics every summation order gives exactly; appends
of recomputed inputs.  Every category ``recompute_rows`` handles is among
them.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pipegen
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.core.recompute import fetch_rows as r_fetch
from repro.core.recompute import recompute_rows as r_recompute
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as r_track
from repro.provenance import prov as rprov
from repro_torch.core.opcat import OpCategory
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.recompute import fetch_rows, recompute_rows
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.kernels import ops as K
from repro_torch.provenance import ProbeValues, RecordValues, prov
from test_torch_capture import build_merged

CPU = "cpu"
HOWS = ["inner", "left", "right", "outer"]
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]

R = SimpleNamespace(index=RIndex, track=r_track, mask=lambda m: m,
                    table=lambda cols, null=None: RTable.from_columns(cols, null=null))
T = SimpleNamespace(index=lambda name: ProvenanceIndex(name, device=CPU), track=track,
                    mask=torch.from_numpy,
                    table=lambda cols, null=None: Table.from_columns(cols, null=null,
                                                                     device=CPU))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x), dtype=np.float32).view(np.uint32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit (NaN keys included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def same_table(got, want):
    """The port's table equals ``repro``'s bit for bit."""
    assert list(got.columns) == list(want.columns)
    assert got.data.dtype == torch.float32 and got.null.dtype == torch.bool
    np.testing.assert_array_equal(_bits(got.data), _bits(want.data))
    np.testing.assert_array_equal(_np(got.null), _np(want.null))
    np.testing.assert_array_equal(_np(got.index), _np(want.index))


def check_recompute(r_idx, t_idx, r_ds, t_ds, rng):
    """``recompute_rows`` on sorted distinct rows and ``fetch_rows`` on
    shuffled duplicates of them, against ``repro``'s."""
    n = t_idx.datasets[t_ds].n_rows
    assert n == r_idx.datasets[r_ds].n_rows
    if n == 0:
        return
    rows = np.unique(rng.integers(0, n, size=min(12, n)))
    same_table(recompute_rows(t_idx, t_ds, rows.tolist()), r_recompute(r_idx, r_ds, rows))
    dup = rng.permutation(np.concatenate([rows, rows[::2]]))
    same_table(fetch_rows(t_idx, t_ds, torch.from_numpy(dup)), r_fetch(r_idx, r_ds, dup))
    # every row, in order: each dataset recomputed whole
    every = np.arange(n)
    same_table(recompute_rows(t_idx, t_ds, torch.from_numpy(every)),
               r_recompute(r_idx, r_ds, every))


def check_values(r_idx, t_idx, r_pair, t_pair, direction, probes):
    """A ``.values()`` plan from ``t_pair[0]`` to ``t_pair[1]`` against
    ``repro``'s plain plan and its ``recompute_rows`` of the answer."""
    (r_src, r_tgt), (t_src, t_tgt) = r_pair, t_pair
    q, rq = prov(t_idx).source(t_src), rprov(r_idx).source(r_src)
    q, rq = (q.forward(), rq.forward()) if direction == "fwd" else (q.backward(), rq.backward())
    got = q.to(t_tgt).rows_batch(probes).values().run()
    want = rq.to(r_tgt).rows_batch(probes).run()
    assert isinstance(got, RecordValues) and len(got) == len(want) == len(probes)
    cols = tuple(t_idx.datasets[t_tgt].columns)
    for g, w in zip(got, want):
        assert isinstance(g, ProbeValues) and g.columns == cols
        assert g.rows.dtype == torch.int64
        np.testing.assert_array_equal(g.rows.numpy(), w)
        ref = r_recompute(r_idx, r_tgt, w)
        assert list(g.columns) == list(ref.columns)
        np.testing.assert_array_equal(_bits(g.data), _bits(ref.data))
        np.testing.assert_array_equal(g.null.numpy(), ref.null)


def _probes(rng, n, B=6):
    """B probe sets over n rows: an empty one, a single row, small sets."""
    if n == 0:
        return [[] for _ in range(B)]
    return [[]] + [[int(rng.integers(n))]] + [
        sorted(set(rng.integers(0, n, size=min(5, n)).tolist())) for _ in range(B - 2)]


def check_world(r_idx, t_idx, r_ids, t_ids, r_src, t_src, r_sink, t_sink, seed):
    """Recomputation of every listed dataset, and values plans to each from
    the source (Q1) and from the sink (Q2)."""
    rng = np.random.default_rng(seed)
    for r_ds, t_ds in zip(r_ids, t_ids):
        check_recompute(r_idx, t_idx, r_ds, t_ds, rng)
    n_src, n_sink = t_idx.datasets[t_src].n_rows, t_idx.datasets[t_sink].n_rows
    for r_ds, t_ds in zip(r_ids, t_ids):
        if r_ds != r_src:
            check_values(r_idx, t_idx, (r_src, r_ds), (t_src, t_ds), "fwd",
                         _probes(rng, n_src))
        if r_ds != r_sink:
            check_values(r_idx, t_idx, (r_sink, r_ds), (t_sink, t_ds), "bwd",
                         _probes(rng, n_sink))


# -- pipegen spec lists -----------------------------------------------------------
@pytest.mark.parametrize("seed", range(10))
def test_spec_lists_recompute_like_reference(seed):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    assert any(not t_idx.datasets[d].materialized for d in t_ids)
    check_world(r_idx, t_idx, r_ids, t_ids, r_ids[0], t_ids[0], r_ids[-1], t_ids[-1], seed)


# -- joins: NaN of either sign and signed zeros, each input kept or recomputed ------
def _join_columns(rng):
    lk = rng.integers(-2, 4, 23).astype(np.float32)
    rk = rng.integers(-2, 4, 17).astype(np.float32)
    lk[lk == 0] = np.where(rng.random(int((lk == 0).sum())) < 0.5, -0.0, 0.0)
    rk[rk == 0] = np.where(rng.random(int((rk == 0).sum())) < 0.5, -0.0, 0.0)
    lk[[1, 8]], rk[[0, 6]] = (NEG_NAN, np.nan), (np.nan, NEG_NAN)
    lk[[4, 19]], rk[[3, 11]] = 7.0, 9.0               # unmatched rows on both sides
    left = {"k": lk, "x": rng.normal(size=23).astype(np.float32),
            "y": rng.normal(size=23).astype(np.float32)}
    right = {"k": rk, "x": rng.normal(size=17).astype(np.float32),
             "z": rng.normal(size=17).astype(np.float32)}
    null = {"y": rng.random(23) < 0.2}
    return left, right, null


def _join_world(pkg, how, keep_left, keep_right, seed):
    left, right, null = _join_columns(np.random.default_rng(seed))
    idx = pkg.index(f"join-{how}")
    a = pkg.track(pkg.table(left, null), idx, "left")
    b = pkg.track(pkg.table(right), idx, "right")
    if not keep_left:
        a = a.value_transform("x", "scale", factor=3.0)
    if not keep_right:
        b = b.filter_rows(pkg.mask(np.arange(17) % 5 != 2))
    j = a.join(b, on="k", how=how)
    out = j.value_transform("y", "scale", factor=0.5)
    sink = out.filter_rows(pkg.mask(np.arange(out.table.n_rows) % 4 != 1)).mark_sink()
    return idx, [a.dataset_id, b.dataset_id, j.dataset_id, out.dataset_id], sink.dataset_id


@pytest.mark.parametrize("keep_left,keep_right", [(True, True), (False, True), (True, False),
                                                  (False, False)])
@pytest.mark.parametrize("how", HOWS)
def test_join_recompute_nan_and_signed_zero_keys(how, keep_left, keep_right):
    r_idx, r_ids, r_sink = _join_world(R, how, keep_left, keep_right, seed=5)
    t_idx, t_ids, t_sink = _join_world(T, how, keep_left, keep_right, seed=5)
    j = t_ids[2]
    assert not t_idx.datasets[j].materialized
    assert [t_idx.datasets[d].materialized for d in t_ids[:2]] == [keep_left, keep_right]
    pairs = t_idx.ops[t_idx.producer[j]].info.join_pairs
    assert bool((pairs[:, 0] >= 0).all()) == (how in ("inner", "left"))
    assert bool((pairs[:, 1] >= 0).all()) == (how in ("inner", "right"))
    check_world(r_idx, t_idx, r_ids, t_ids, r_ids[0], t_ids[0], r_sink, t_sink, seed=11)
    # the join's rows come from one join_gather, whichever inputs are kept
    K.reset_launch_counts()
    recompute_rows(t_idx, j, torch.arange(t_idx.datasets[j].n_rows))
    assert K.launch_counts().get("join_gather") == 1


def test_join_layout_is_checked():
    t_idx, t_ids, _ = _join_world(T, "inner", True, True, seed=5)
    op = t_idx.ops[t_idx.producer[t_ids[2]]]
    op.info.attr_maps[1].perm = op.info.attr_maps[1].perm.flip(0)
    with pytest.raises(ValueError, match="layout"):
        recompute_rows(t_idx, t_ids[2], [0])


# -- oversampling with noise ---------------------------------------------------------
def _oversample_world(pkg, keep_input):
    rng = np.random.default_rng(17)
    cols = {"k": np.arange(20, dtype=np.float32), "x": rng.normal(size=20).astype(np.float32),
            "y": rng.normal(size=20).astype(np.float32)}
    idx = pkg.index("jitter")
    src = pkg.track(pkg.table(cols, {"y": rng.random(20) < 0.3}), idx, "src")
    mid = src if keep_input else src.value_transform("x", "scale", factor=2.0)
    ov = mid.oversample(frac=0.6, seed=42, noise=0.2)
    out = ov.value_transform("x", "scale", factor=1.5).mark_sink()
    ids = [src.dataset_id] + ([] if keep_input else [mid.dataset_id]) + [ov.dataset_id]
    return idx, ids + [out.dataset_id], out.dataset_id


@pytest.mark.parametrize("keep_input", [True, False])
def test_oversample_noise_recomputes_exactly(keep_input):
    r_idx, r_ids, r_sink = _oversample_world(R, keep_input)
    t_idx, t_ids, t_sink = _oversample_world(T, keep_input)
    ov = t_ids[-2]
    assert t_idx.ops[t_idx.producer[ov]].info.category is OpCategory.HAUGMENT
    assert not t_idx.datasets[ov].materialized and t_idx.datasets[ov].n_rows > 20
    check_world(r_idx, t_idx, r_ids, t_ids, r_ids[0], t_ids[0], r_sink, t_sink, seed=3)


# -- contextual ops whose inputs the policy keeps -------------------------------------
def _contextual_world(pkg):
    """32 rows of small whole numbers: every mean, deviation and bin edge
    is exact in float32 whatever the order of summation, so both packages
    store the same statistics."""
    rng = np.random.default_rng(23)
    cols = {"a": rng.integers(0, 8, 32).astype(np.float32),
            "b": rng.integers(-4, 4, 32).astype(np.float32),
            "c": rng.integers(0, 4, 32).astype(np.float32),
            "g": rng.integers(0, 4, 32).astype(np.float32)}
    null = {"a": rng.random(32) < 0.25, "c": rng.random(32) < 0.2}
    idx = pkg.index("ctx")
    src = pkg.track(pkg.table(cols, null), idx, "src")
    t1 = src.value_transform("c", "scale", factor=2.0)      # kept: impute reads it
    t2 = t1.impute(["a"], strategy="mean")                   # kept: normalize reads it
    t3 = t2.normalize(["b"], kind="zscore")                  # recomputed
    t4 = t3.onehot("g", n_values=4)                          # recomputed
    t5 = t4.normalize(["c"], kind="minmax")                  # t4 kept after all
    t6 = t5.drop_columns(["a"])                              # recomputed
    t7 = t6.discretize("b", n_bins=4)                        # contextual: t6 kept
    t8 = t7.select_columns(["b", "c", "g=1", "g=2"])          # recomputed
    sink = t8.filter_rows(pkg.mask(np.arange(32) % 3 != 0)).mark_sink()
    ts = [src, t1, t2, t3, t4, t5, t6, t7, t8]
    return idx, [t.dataset_id for t in ts], sink.dataset_id


def test_contextual_ops_recompute_from_kept_inputs():
    r_idx, r_ids, r_sink = _contextual_world(R)
    t_idx, t_ids, t_sink = _contextual_world(T)
    kept = [t_idx.datasets[d].materialized for d in t_ids]
    assert kept == [True, True, True, False, True, False, True, False, False]
    for r_op, t_op in zip(r_idx.ops, t_idx.ops):
        assert t_op.info.params == r_op.info.params        # the same statistics
    check_world(r_idx, t_idx, r_ids, t_ids, r_ids[0], t_ids[0], r_sink, t_sink, seed=7)


# -- appends of recomputed inputs ----------------------------------------------------
def _append_world(pkg):
    rng = np.random.default_rng(29)
    a = {"x": rng.normal(size=14).astype(np.float32), "k": rng.integers(0, 5, 14).astype(np.float32)}
    b = {"x": rng.normal(size=9).astype(np.float32), "w": rng.normal(size=9).astype(np.float32)}
    idx = pkg.index("app")
    src = pkg.track(pkg.table(a), idx, "src")
    other = pkg.track(pkg.table(b, {"w": rng.random(9) < 0.3}), idx, "other")
    left = src.filter_rows(pkg.mask(np.arange(14) % 4 != 0))
    right = other.value_transform("w", "scale", factor=4.0)
    app = left.append(right)
    out = app.value_transform("x", "scale", factor=2.0)
    sink = out.undersample(frac=0.8, seed=3).mark_sink()
    ids = [src.dataset_id, left.dataset_id, right.dataset_id, app.dataset_id, out.dataset_id]
    return idx, ids, sink.dataset_id


def test_append_of_recomputed_inputs():
    r_idx, r_ids, r_sink = _append_world(R)
    t_idx, t_ids, t_sink = _append_world(T)
    assert not any(t_idx.datasets[d].materialized for d in t_ids[1:])
    check_world(r_idx, t_idx, r_ids, t_ids, r_ids[0], t_ids[0], r_sink, t_sink, seed=13)


# -- the values result ----------------------------------------------------------------
def test_values_of_a_kept_target_are_its_stored_rows():
    t_idx, t_ids, t_sink = _join_world(T, "outer", True, True, seed=5)
    stored = t_idx.datasets[t_sink].table
    got = prov(t_idx).source("left").rows_batch([[0, 3], [], [5]]).forward().to(t_sink) \
        .values().run()
    for g in got:
        assert same_bits(g.data, stored.data[g.rows])
        assert torch.equal(g.null, stored.null[g.rows])


def test_values_result_slices_and_single_probes():
    t_idx, t_ids, t_sink = _join_world(T, "left", False, True, seed=5)
    j = t_ids[2]
    probes = [[0, 1], [], [2], [4, 5, 6]]
    res = prov(t_idx).source(t_sink).rows_batch(probes).backward().to(j).values().run()
    assert res.offsets[0] == 0 and res.offsets[-1] == len(res.rows) == res.data.shape[0]
    assert res.data.shape[1] == len(res.columns) == t_idx.datasets[j].n_cols
    sub = res[1:3]
    assert isinstance(sub, RecordValues) and len(sub) == 2 and sub.offsets[0] == 0
    for g, w in zip(sub, list(res)[1:3]):
        assert torch.equal(g.rows, w.rows) and same_bits(g.data, w.data)
    assert len(res[2:2]) == 0
    for b, p in enumerate(probes):
        one = prov(t_idx).source(t_sink).rows(p).backward().to(j).values().run()
        assert isinstance(one, ProbeValues)
        assert torch.equal(one.rows, res[b].rows) and same_bits(one.data, res[b].data)
        assert torch.equal(one.null, res[b].null)
    with pytest.raises(ValueError):
        res[::2]


@pytest.mark.parametrize("spell", ["how", "cells", "transformations", "co_contributory",
                                   "co_dependency"])
def test_values_refused_off_plain_record_plans(spell):
    t_idx, t_ids, t_sink = _join_world(T, "inner", True, True, seed=5)
    q = prov(t_idx).source("left").rows([0])
    q = {"how": lambda: q.forward().to(t_sink).how(),
         "cells": lambda: q.attrs([0]).forward().to(t_sink),
         "transformations": lambda: prov(t_idx).source(t_sink).transformations(),
         "co_contributory": lambda: q.co_contributory("right"),
         "co_dependency": lambda: prov(t_idx).source(t_ids[2]).rows([0])
         .co_dependency("left", t_sink)}[spell]()
    with pytest.raises(ValueError, match="values|how-provenance"):
        q.values().plan()
