"""The benchmark's tests of the Census configuration and the attribute
cell ``census.attr-batch``, on the CPU at the harness tests' cut size (or
on a card where there is one): planted faults in the timed path read not
correct; the reference's ``onehot`` op and how-traces on a hand-worked
table, held to the port there too; the table generator's shape and
domains."""
import dataclasses

import numpy as np
import pytest
import torch

from provbench import harness, program
from provbench.hosttable import HostTable
from provbench.reference import how
from provbench.reference.lineage import run_pipeline, value_gap
from provbench.tables import census
from provbench.test_provbench_harness import SEED, cut

CELL = "census.attr-batch"


@pytest.fixture(scope="module")
def device():
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def run(device):
    b = harness.bench()
    config = cut(harness.config_of(b, harness.cell_of(b, CELL)["config"]))
    return harness.run_cell(CELL, SEED, 0.2, False, device, config=config)


def _per_probe(res, fn):
    """``fn(b, cells, hops)`` -> (cells, hops) over each probe's answer;
    hops is None for a Q3/Q4 answer."""
    out = []
    for b, r in enumerate(res):
        cells, hops = r if isinstance(r, tuple) else (r, None)
        cells, hops = fn(b, cells, hops)
        out.append(cells if hops is None else (cells, hops))
    return out


def _altered(b, cells, hops):
    if b == 0:
        cells = cells.clone()
        if cells.numel():
            cells.view(-1)[0] += 1
        else:
            cells = torch.zeros((1, 2), dtype=torch.int64, device=cells.device)
    return cells, hops


def _half(n):
    def fn(b, cells, hops):
        if b < n // 2:
            return cells, hops
        return cells[:0], None if hops is None else []
    return fn


def _hop_dropped(b, cells, hops):
    return cells, hops if hops is None or b else hops[:-1]


def _count_off(b, cells, hops):
    if hops is None or b or not hops:
        return cells, hops
    return cells, [dataclasses.replace(hops[0], n_records=hops[0].n_records + 1)] + hops[1:]


FAULTS = {
    "altered": lambda res: _per_probe(res, _altered),
    "half_batch": lambda res: _per_probe(res, _half(len(res))),
    "hop_dropped": lambda res: _per_probe(res, _hop_dropped),
    "hop_count_off": lambda res: _per_probe(res, _count_off),
}

# the checks each fault must break, and no others
BROKEN = {"altered": {"wrong_answers"}, "half_batch": {"wrong_answers", "wrong_hops"},
          "hop_dropped": {"wrong_hops"}, "hop_count_off": {"wrong_hops"}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_attr_fault_fails(fault, device, monkeypatch):
    """A planted fault in the timed path: one probe's cells altered, the
    second half of a batch's answers left out, one hop of a trace left
    out, one hop's record count off by one."""
    from repro_torch.provenance.session import QuerySession

    orig = QuerySession.run
    monkeypatch.setattr(QuerySession, "run",
                        lambda self, plan: FAULTS[fault](orig(self, plan)))
    r = run(device)
    assert not r["correct"], r["checks"]
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad == BROKEN[fault]


# a hand-worked table: c's codes with a null (row 2), one past the domain
# (row 3), one below it (row 4) and one cast down (2.7 -> 2, row 5)
HAND = HostTable(["c", "x"],
                 np.array([[0, 1], [2, -1], [1, 2], [5, -2], [-1, 3], [2.7, -3]], np.float32),
                 np.array([[0, 0], [0, 0], [1, 0], [0, 0], [0, 0], [0, 0]], bool))
HAND_CONFIG = {"name": "hand", "sources": ["t"], "start": "t", "pipeline": [
    {"op": "normalize", "args": {"cols": ["x"], "kind": "zscore"}},
    {"op": "onehot", "args": {"col": "c", "n_values": 3}},
    {"op": "filter_gt", "args": {"col": "x", "value": 0.0}},
    {"op": "select_columns", "args": {"cols": ["x", "c=2"]}},
]}
DT, VA, HR, VR = ("data_transformation", "vertical_augmentation", "horizontal_reduction",
                  "vertical_reduction")
# (kind, probe rows, probe attrs, trace): from t for q7, from the sink
# (x, c=2 over rows 0, 2, 4 of t) for q8
HAND_TRACES = [
    ("q7", [0, 1], [0], [(0, DT, 2), (1, VA, 2), (2, HR, 1), (3, VR, 1)]),
    ("q7", [1, 5], [0], [(0, DT, 2), (1, VA, 2)]),
    ("q7", [1, 0, 1], [1], [(0, DT, 2), (1, VA, 2), (2, HR, 1), (3, VR, 1)]),
    ("q8", [0, 2, 2], [0], [(3, VR, 2), (2, HR, 2), (1, VA, 2), (0, DT, 2)]),
    ("q8", [1], [1], [(3, VR, 1), (2, HR, 1), (1, VA, 1), (0, DT, 1)]),
]


def test_reference_onehot_hand_worked():
    lin = run_pipeline({"start": "t", "pipeline": [HAND_CONFIG["pipeline"][1]]}, {"t": HAND})
    sink = lin.sink
    assert sink.columns == ["c", "x", "c=0", "c=1", "c=2"]
    assert sink.data[:, 2:].tolist() == [[1, 0, 0], [0, 0, 1], [0, 0, 0], [0, 0, 0],
                                         [0, 0, 0], [0, 0, 1]]
    assert not sink.null[:, 2:].any() and np.array_equal(sink.null[:, :2], HAND.null)
    (_, _, [(name, rows, cols)]), = lin.ops
    assert name == "cur" and rows.tolist() == list(range(6)) and cols.tolist() == [0, 1, 0, 0, 0]


def test_reference_how_hand_worked():
    lin = run_pipeline(HAND_CONFIG, {"t": HAND})
    assert lin.sink.columns == ["x", "c=2"] and lin.maps["t"][0].tolist() == [0, 2, 4]
    traces = how.Traces(HAND_CONFIG, lin)
    for q, rows, attrs, want in HAND_TRACES:
        assert traces.answer(q, "t", [rows], [attrs]) == [want], (q, rows, attrs)
    assert how.count_wrong([[(0, DT, 2)]], [[(0, DT, 3)]]) == 1
    assert how.count_wrong([], [[]]) == 1


def test_port_agrees_on_hand_worked_table():
    """The port's onehot and its Q7/Q8 traces on the same table (CPU)."""
    from provbench.loops.closed_attr_queries import build_plan
    from provbench.streams import Call

    index, sink = program.capture(HAND_CONFIG, {"t": program.to_device(HAND, "cpu")}, "cpu")
    lin = run_pipeline(HAND_CONFIG, {"t": HAND})
    assert value_gap(program.sink_to_host(index, sink), lin.sink) < 1e-6
    for q, rows, attrs, want in HAND_TRACES:
        call = Call(q, "t", np.array([rows]), np.array([attrs]))
        (_, hops), = index.session().run(build_plan(index, sink, call))
        assert [(h.op_id, h.category, h.n_records) for h in hops] == want


def test_census_table_shape_and_domains():
    params = {"name": "census_src", "rows": 4000, "domains": [9, 16, 64, 7, 15, 6, 5, 2, 2],
              "numeric": 6, "null_frac": 0.02}
    t = census.make(params, np.random.default_rng(SEED))["census_src"]
    assert (t.n_rows, t.n_cols) == (4000, 15) and t.columns == [f"a{j}" for j in range(15)]
    assert t.data.dtype == np.float32
    for j, d in enumerate(params["domains"]):
        assert np.array_equal(np.unique(t.data[:, j]), np.arange(d))
    x = t.data[:, 9:]
    assert np.all(np.abs(x.mean(0)) < 0.1) and np.all(np.abs(x.std(0) - 1) < 0.1)
    assert 0.015 < t.null.mean() < 0.025
