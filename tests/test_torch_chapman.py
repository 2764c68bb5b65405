"""The port's Chapman baseline against ``repro``'s, byte for byte.

Twins of ``tests/test_baseline_agreement.py`` (a linear chain, a join, the
memory order of Table IX), run through both packages on the same numpy
inputs: the port's ``ChapmanIndex`` must hold ``records`` equal to
``repro``'s (dtype, shape and order), the same three byte counts, and the
same scan answers, which must in turn agree with the port's index.  Beyond
the twins: joins with nulls and value-identical duplicate rows (several
hash matches per output row), joins whose right key is not its first column
(every right link a captured-pair fill-in), outer joins, pipelines replayed
from ``pipegen.random_specs`` and the German use case, each captured through
``add_record_hook`` as ``benchmarks/bench_memory.py`` does.
"""
import numpy as np
import pytest
import torch

import pipegen
from repro.core.chapman import ChapmanIndex as RChapman
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import ops as RO
from repro.dataprep import usecases as RU
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as rtrack
from repro_torch.core.chapman import ChapmanIndex
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import ops as TO
from repro_torch.dataprep import usecases as TU
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track as ttrack
from repro_torch.provenance import prov
from test_torch_capture import apply_spec

CPU = "cpu"


def _mirror(idx, chapman):
    """Mirror every capture of ``idx`` into ``chapman`` (the record hook)."""
    idx.add_record_hook(lambda input_ids, output_id, out_table, info, input_tables:
                        chapman.capture(input_ids, input_tables, output_id, out_table, info))
    return chapman


def _same_store(t: ChapmanIndex, r: RChapman) -> None:
    assert [c.op_name for c in t.cells] == [c.op_name for c in r.cells]
    for tc, rc in zip(t.cells, r.cells):
        assert tc.records.dtype == torch.int64 and tc.records.device.type == "cpu"
        got = tc.records.numpy()
        assert got.shape == rc.records.shape
        assert got.tobytes() == rc.records.tobytes()
    # dataset ids come from each package's own counter: frames are compared
    # in capture order
    assert [f.nbytes() for f in t.frames.values()] == [f.nbytes() for f in r.frames.values()]
    assert (t.prov_nbytes(), t.frames_nbytes(), t.total_nbytes()) == \
        (r.prov_nbytes(), r.frames_nbytes(), r.total_nbytes())


def _dual(seq, cols, nulls=None):
    """Run one op sequence through both packages' ops, capturing each op
    into both Chapman stores directly (``_dual_capture`` of the twin)."""
    r_tabs = {"S": RTable.from_columns(cols, null=nulls)}
    t_tabs = {"S": Table.from_columns(cols, null=nulls, device=CPU)}
    rch, tch = RChapman(), ChapmanIndex()
    tidx = ProvenanceIndex("t", device=CPU)
    tidx.add_source("S", t_tabs["S"])
    for i, (fn, in_names, out_name) in enumerate(seq):
        r_out, r_info = fn(RO, *[r_tabs[n] for n in in_names])
        t_ins = [t_tabs[n] for n in in_names]
        t_out, t_info = fn(TO, *t_ins)
        rch.capture(list(in_names), [r_tabs[n] for n in in_names], out_name, r_out, r_info)
        tch.capture(list(in_names), t_ins, out_name, t_out, t_info)
        tidx.record(list(in_names), out_name, t_out, t_info,
                    keep_output=(i == len(seq) - 1), input_tables=t_ins)
        r_tabs[out_name], t_tabs[out_name] = r_out, t_out
    return tch, rch, tidx, t_tabs


def _q2(idx, sink, rows, src):
    return prov(idx).source(sink).rows(rows).backward().to(src).run().tolist()


def _q1(idx, src, rows, sink):
    return prov(idx).source(src).rows(rows).forward().to(sink).run().tolist()


def test_agreement_on_linear_chain():
    rng = np.random.default_rng(0)
    cols = {"a": rng.integers(0, 5, 30).astype(np.float32),
            "b": rng.normal(size=30).astype(np.float32),
            "c": rng.normal(size=30).astype(np.float32)}
    seq = [
        (lambda P, t: P.filter_rows(t, np.asarray(t.col("b")) > -1.0), ["S"], "F"),
        (lambda P, t: P.value_transform(t, "c", "clip", lo=-1, hi=1), ["F"], "T"),
        (lambda P, t: P.onehot(t, "a", n_values=5), ["T"], "O"),
    ]
    tch, rch, tidx, tabs = _dual(seq, cols)
    _same_store(tch, rch)
    ids = [0, 1, 2]
    for row in range(0, tabs["O"].n_rows, 3):
        got = tch.backward_rows(ids, [row])
        assert got.dtype == torch.int64
        assert got.tolist() == rch.backward_rows(ids, [row]).tolist() == \
            _q2(tidx, "O", [row], "S")
    for row in range(0, tabs["S"].n_rows, 5):
        got = tch.forward_rows(ids, [row])
        assert got.tolist() == rch.forward_rows(ids, [row]).tolist() == \
            _q1(tidx, "S", [row], "O")


def test_agreement_on_join():
    rng = np.random.default_rng(1)
    lcols = {"k": rng.integers(0, 8, 20).astype(np.float32),
             "x": rng.normal(size=20).astype(np.float32)}
    rcols = {"k": np.arange(8, dtype=np.float32), "y": rng.normal(size=8).astype(np.float32)}
    rl, rr = RTable.from_columns(lcols), RTable.from_columns(rcols)
    tl, tr = Table.from_columns(lcols, device=CPU), Table.from_columns(rcols, device=CPU)
    r_out, r_info = RO.join(rl, rr, on="k", how="inner")
    t_out, t_info = TO.join(tl, tr, on="k", how="inner")
    rch, tch = RChapman(), ChapmanIndex()
    rch.capture(["L", "R"], [rl, rr], "J", r_out, r_info)
    tch.capture(["L", "R"], [tl, tr], "J", t_out, t_info)
    _same_store(tch, rch)
    tidx = ProvenanceIndex("t", device=CPU)
    tidx.add_source("L", tl)
    tidx.add_source("R", tr)
    tidx.record(["L", "R"], "J", t_out, t_info, keep_output=True, input_tables=[tl, tr])
    for row in range(t_out.n_rows):
        c = tch.backward_rows([0], [row]).tolist()
        assert c == rch.backward_rows([0], [row]).tolist()
        # slots merge; hash matching may widen to value-identical rows
        assert set(_q2(tidx, "J", [row], "L")) | set(_q2(tidx, "J", [row], "R")) <= set(c)


def test_chapman_memory_is_larger():
    """Table IX's qualitative claim, with both packages' byte counts equal."""
    rng = np.random.default_rng(2)
    cols = {f"a{i}": rng.normal(size=500).astype(np.float32) for i in range(10)}
    seq = [
        (lambda P, t: P.filter_rows(t, np.asarray(t.col("a0")) > -0.5), ["S"], "F"),
        (lambda P, t: P.normalize(t, ["a1", "a2"]), ["F"], "N"),
        (lambda P, t: P.drop_columns(t, ["a9"]), ["N"], "D"),
    ]
    tch, rch, tidx, _ = _dual(seq, cols)
    _same_store(tch, rch)
    assert tch.total_nbytes() > 5 * tidx.prov_nbytes()


def _join_inputs(seed, key_first: bool):
    """Left rows with nulls, duplicate keys and value-identical duplicate
    rows; a right table whose key is its first column or its second."""
    rng = np.random.default_rng(seed)
    n = 24
    left = {"k": rng.integers(0, 6, n).astype(np.float32),
            "x": np.round(rng.normal(size=n), 1).astype(np.float32),
            "g": rng.integers(0, 3, n).astype(np.float32)}
    for c in left.values():
        c[n // 2:n // 2 + 4] = c[:4]                # value-identical rows
    lnull = {"x": rng.random(n) < 0.2, "g": rng.random(n) < 0.1}
    lnull["x"][n // 2:n // 2 + 4] = lnull["x"][:4]
    lnull["g"][n // 2:n // 2 + 4] = lnull["g"][:4]
    m = 9
    right = {"z": rng.normal(size=m).astype(np.float32),
             "k": rng.integers(0, 8, m).astype(np.float32),
             "w": rng.normal(size=m).astype(np.float32)}
    if key_first:
        right = {"k": right["k"], "z": right["z"], "w": right["w"]}
    rnull = {"w": rng.random(m) < 0.3}
    return left, lnull, right, rnull


@pytest.mark.parametrize("key_first", [True, False])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_records_byte_for_byte(how, key_first):
    lc, ln, rc, rn = _join_inputs(3 + key_first, key_first)
    rl, rr = RTable.from_columns(lc, null=ln), RTable.from_columns(rc, null=rn)
    tl, tr = (Table.from_columns(lc, null=ln, device=CPU),
              Table.from_columns(rc, null=rn, device=CPU))
    r_out, r_info = RO.join(rl, rr, on="k", how=how)
    t_out, t_info = TO.join(tl, tr, on="k", how=how)
    rch, tch = RChapman(), ChapmanIndex()
    rch.capture(["L", "R"], [rl, rr], "J", r_out, r_info)
    tch.capture(["L", "R"], [tl, tr], "J", t_out, t_info)
    _same_store(tch, rch)
    recs = rch.cells[0].records
    right_links = recs[recs[:, 2] == 1]
    if not key_first:
        # no right row hashes like its output projection: every right link
        # is a captured-pair fill-in, after every hash match
        assert len(right_links) and (np.flatnonzero(recs[:, 2] == 1)[0]
                                     > np.flatnonzero(recs[:, 2] == 0)[-1])
    # several left rows share values: some output row matches two of them
    _, per_row = np.unique(recs[(recs[:, 2] == 0) & (recs[:, 1] == 0)][:, 0],
                           return_counts=True)
    assert per_row.max() >= 2
    for row in range(0, t_out.n_rows, 2):
        assert tch.backward_rows([0], [row]).tolist() == rch.backward_rows([0], [row]).tolist()
    for row in range(0, tl.n_rows, 3):
        assert tch.forward_rows([0], [row]).tolist() == rch.forward_rows([0], [row]).tolist()


def test_hash_is_repro_uint64():
    """The int64 FNV product has the bits of ``repro``'s wrapping uint64 one,
    nulls hashing as ``np.float32(np.nan)``."""
    lc, ln, _, _ = _join_inputs(5, True)
    want = RChapman._hash_rows(RTable.from_columns(lc, null=ln), [0, 2])
    got = ChapmanIndex._hash_rows(Table.from_columns(lc, null=ln, device=CPU), [0, 2])
    assert got.numpy().view(np.uint64).tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_pipegen_stores_match_reference(seed):
    """Every op category of the spec replay (filters, scales, over/under-
    sampling, inner and outer joins, appends) through the record hook."""
    base, specs = pipegen.random_specs(seed)
    rch, tch = RChapman(), ChapmanIndex()
    r_idx = RIndex("merged")
    _mirror(r_idx, rch)
    t_idx = ProvenanceIndex("merged", device=CPU)
    _mirror(t_idx, tch)
    rcur = rtrack(RTable.from_columns({c: v.copy() for c, v in base.items()}), r_idx, "src")
    tcur = ttrack(Table.from_columns({c: v.copy() for c, v in base.items()}, device=CPU),
                  t_idx, "src")
    for spec in specs:
        rcur = pipegen.apply_spec(rcur, spec, r_idx)
        tcur = apply_spec(tcur, spec, t_idx)
    _same_store(tch, rch)
    ops = list(range(len(tch.cells)))
    rng = np.random.default_rng(seed)
    n_out = rcur.table.n_rows
    for _ in range(4):
        rows = sorted(set(rng.integers(0, n_out, size=3).tolist()))
        assert tch.backward_rows(ops, rows).tolist() == rch.backward_rows(ops, rows).tolist()


def test_german_use_case_matches_reference():
    rch, tch = RChapman(), ChapmanIndex()
    r_idx, t_idx = RIndex("german"), ProvenanceIndex("german", device=CPU)
    _mirror(r_idx, rch)
    _mirror(t_idx, tch)
    mk_r, run_r = RU.USECASES["german"]
    mk_t, run_t = TU.USECASES["german"]
    r_sink = run_r(r_idx, mk_r(0))
    t_sink = run_t(t_idx, mk_t(0, device=CPU))
    _same_store(tch, rch)
    ops = list(range(len(tch.cells)))
    src = t_idx.sources()[0]
    for row in (0, 17, 999):
        want = _q2(t_idx, t_sink.dataset_id, [row], src)
        assert tch.backward_rows(ops, [row]).tolist() == want == \
            rch.backward_rows(ops, [row]).tolist()
        assert tch.forward_rows(ops, [row]).tolist() == _q1(t_idx, src, [row], t_sink.dataset_id)
    assert r_sink.table.n_rows == t_sink.table.n_rows
    assert tch.total_nbytes() > t_idx.prov_nbytes()


def test_store_rejects_a_table_on_another_device():
    """The store lies on the device of its first capture."""
    t = Table.from_columns({"a": np.arange(4, dtype=np.float32)}, device=CPU)
    out, info = TO.value_transform(t, "a", "scale", factor=2.0)
    tch = ChapmanIndex()
    tch.capture(["S"], [t], "O", out, info)
    assert tch.device == torch.device("cpu")
    elsewhere = Table(columns=list(out.columns), data=out.data.to("meta"), null=None,
                      index=None)
    with pytest.raises(ValueError):
        tch.capture(["O"], [out], "P", elsewhere, info)


def test_row_tuple_matches_reference():
    """Value identity of a row: nulls as NaN, zeros (either sign) as -0.0."""
    lc, ln, _, _ = _join_inputs(6, True)
    lc["x"][:3] = [0.0, -0.0, 1.5]
    rt, tt = RTable.from_columns(lc, null=ln), Table.from_columns(lc, null=ln, device=CPU)
    for i in range(rt.n_rows):
        want, got = np.array(rt.row_tuple(i)), np.array(tt.row_tuple(i))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        assert all(type(v) is float for v in tt.row_tuple(i))
