"""The benchmark's tests of the cell ``tpcdi_sf20.values-batch``, on the CPU
at the harness tests' cut size (or on a card where there is one): the
cell reads correct; planted faults in the timed path (a column dropped,
two probes' values swapped, a stale null flag, a probe's rows out of
order) read not correct, each through the checks it must break; the
control (the reference in bfloat16) reads ``wrong_values``; the values
reference on a hand-worked join; the static checks."""
import numpy as np
import pytest
import torch

from provbench import harness, static_check
from provbench.hosttable import HostTable
from provbench.reference import values as ref_values
from provbench.test_provbench_harness import SEED, cut

CELL = "tpcdi_sf20.values-batch"


@pytest.fixture(scope="module")
def device():
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def run(device, control=False, seed=SEED):
    b = harness.bench()
    config = cut(harness.config_of(b, harness.cell_of(b, CELL)["config"]))
    return harness.run_cell(CELL, seed, 0.2, False, device, config=config, control=control)


def test_values_cell_correct(device):
    r = run(device)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"wrong_answers", "wrong_values", "unanswered", "sink_value_gap"}
    assert set(r["metrics"]) == {"query_p95_ms", "probes_per_s", "setup_s"}


def _probes_with_rows(res, n=2):
    """The first ``n`` probes that hold two rows or more: their offsets."""
    o = res.offsets
    found = [(a, b) for a, b in zip(o, o[1:]) if b - a >= 2][:n]
    assert len(found) == n
    return found


def _dropped_column(res):
    return type(res)(res.columns[:-1], res.rows, res.data[:, :-1], res.null[:, :-1],
                     res.offsets)


def _swapped(res):
    (a, _), (b, _) = _probes_with_rows(res)
    data = res.data.clone()
    data[[a, b]] = res.data[[b, a]]
    return type(res)(res.columns, res.rows, data, res.null, res.offsets)


def _stale_null(res):
    (a, _), = _probes_with_rows(res, 1)
    null = res.null.clone()
    null[a, 1] = ~null[a, 1]
    return type(res)(res.columns, res.rows, res.data, null, res.offsets)


def _out_of_order(res):
    (a, b), = _probes_with_rows(res, 1)
    order = torch.arange(len(res.rows))
    order[a:b] = order[a:b].flip(0)
    return type(res)(res.columns, res.rows[order], res.data[order], res.null[order],
                     res.offsets)


FAULTS = {"dropped_column": _dropped_column, "swapped": _swapped, "stale_null": _stale_null,
          "out_of_order": _out_of_order}
# the checks each fault must break, and no others
BROKEN = {"dropped_column": {"wrong_values"}, "swapped": {"wrong_values"},
          "stale_null": {"wrong_values"}, "out_of_order": {"wrong_answers", "wrong_values"}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_values_fault_fails(fault, device, monkeypatch):
    from repro_torch.provenance.session import QuerySession

    orig = QuerySession.run
    monkeypatch.setattr(QuerySession, "run", lambda self, plan: FAULTS[fault](orig(self, plan)))
    r = run(device)
    assert not r["correct"], r["checks"]
    assert r["failed"] == 0
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad == BROKEN[fault]


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_values_control_reads_wrong_values(device, seed):
    r = run(device, control=True, seed=seed)
    assert r["correct"]
    assert r["control"]["wrong_values"] > 0, r["control"]


def test_values_reference_by_hand():
    """Trades 0-3 join securities by key, then ``l0 > 0`` keeps joined rows
    0 and 2: the target is the join's output (step 0)."""
    trade = HostTable(["key", "l0"], np.array([[1, 2], [0, -1], [1, 3], [2, -4]], np.float32),
                      np.array([[0, 0], [0, 1], [0, 0], [0, 0]], bool))
    security = HostTable(["key", "r0"], np.array([[0, 10], [1, 11], [2, 12]], np.float32),
                         np.zeros((3, 2), bool))
    config = {"start": "trade", "pipeline": [
        {"op": "join", "args": {"right": "security", "on": "key"}},
        {"op": "filter_gt", "args": {"col": "l0", "value": 0.0}}]}
    tgt = ref_values.run_to(config, {"trade": trade, "security": security}, 0)
    assert tgt.table.columns == ["key", "l0", "r0"]
    q2 = tgt.answer("q2", "trade", np.array([[1], [0]]))
    assert [r.tolist() for r, _, _ in q2] == [[2], [0]]
    assert q2[0][1].tolist() == [[1, 3, 11]] and q2[1][1].tolist() == [[1, 2, 11]]
    q1 = tgt.answer("q1", "security", [[1], [0, 2]])
    assert [r.tolist() for r, _, _ in q1] == [[0, 2], [1, 3]]
    assert q1[1][2].tolist() == [[False, True, False], [False, False, False]]
    assert ref_values.probe_differs(q1[1], q1[0], tgt.table.columns, tgt.table.columns)
    assert not ref_values.probe_differs(q1[1], q1[1], tgt.table.columns, tgt.table.columns)
    assert tgt.lineage.sink.n_rows == 2


def test_static_checks_pass_with_the_values_cell():
    assert list(static_check.faults()) == []
    assert CELL in {w["name"] for w in harness.bench()["workloads"]}
