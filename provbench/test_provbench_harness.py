"""The benchmark's own tests, on the CPU at cut sizes (or on a card where
there is one): each cell's run judged correct against the plain
reference; the control (the reference in bfloat16) and planted faults
judged not correct; the static checks."""
import copy
import json

import numpy as np
import pytest
import torch

from provbench import harness, static_check
from provbench.hosttable import HostTable
from provbench.reference import round_bf16
from provbench.reference.lineage import run_pipeline

SEED = 2**31 + 12345          # past 32 signed bits


@pytest.fixture(scope="module")
def device():
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def cut(config: dict) -> dict:
    """The configuration at a size a test holds: Compas 400 rows keeping
    380, TPC-DI 3,000 x 3,300."""
    config = copy.deepcopy(config)
    for t in config["tables"]:
        p = t["params"]
        if "rows" in p:
            p["rows"] = 400
        if "left_rows" in p:
            p["left_rows"], p["right_rows"] = 3000, 3300
    for step in config["pipeline"]:
        if step["op"] == "filter_top_k":
            step["args"]["k"] = 380
    return config


def cells():
    return [w["name"] for w in harness.bench()["workloads"]]


def run(cell, device, seed=SEED, trace=False, control=False):
    b = harness.bench()
    w = harness.cell_of(b, cell)
    return harness.run_cell(cell, seed, 0.2, trace, device, config=cut(harness.config_of(b, w["config"])),
                            control=control)


@pytest.mark.parametrize("cell", cells())
def test_cell_correct(cell, device):
    r = run(cell, device)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    json.dumps(r)


@pytest.mark.parametrize("cell", cells())
def test_cell_traced(cell, device):
    r = run(cell, device, trace=True)
    assert r["correct"]
    names = {m["name"] for m in harness.metrics_for(harness.bench(), cell, True)}
    assert set(r["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", [3, 2**32 + 5, -7])
def test_control_fails(cell, device, seed):
    """The reference in bfloat16 in the port's place reads past a limit."""
    r = run(cell, device, seed=seed, control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(v > limits[k] for k, v in r["control"].items()), r["control"]


def _drop_second_half(res):
    out = list(res)
    for b in range(len(out) // 2, len(out)):
        out[b] = out[b][:0]
    return out


def _alter_one(res):
    out = list(res)
    out[0] = out[0].clone()
    if out[0].numel():
        out[0].view(-1)[0] += 1
    else:
        out[0] = torch.zeros(1, dtype=torch.int64, device=out[0].device)
    return out


def _unchanged(plan):
    return [torch.nonzero(m).reshape(-1) for m in plan.rows]


QUERY_FAULTS = {
    "unchanged": lambda orig: lambda self, plan: _unchanged(plan),
    "half_batch": lambda orig: lambda self, plan: _drop_second_half(orig(self, plan)),
    "altered": lambda orig: lambda self, plan: _alter_one(orig(self, plan)),
}


@pytest.mark.parametrize("fault", sorted(QUERY_FAULTS))
@pytest.mark.parametrize("cell", [c for c in cells() if "lineage" in c])
def test_query_fault_fails(cell, fault, device, monkeypatch):
    """A planted fault in the timed path: the state (the probe) returned
    unchanged, half of a batch's answers left out, one answer altered."""
    from repro_torch.provenance.session import QuerySession

    orig = QuerySession.run
    monkeypatch.setattr(QuerySession, "run", QUERY_FAULTS[fault](orig))
    r = run(cell, device)
    assert not r["correct"], r["checks"]


def _capture_fault(fault, monkeypatch):
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import ops

    if fault == "unchanged":        # the index's op records never change
        monkeypatch.setattr(ProvenanceIndex, "add_op", lambda self, *a, **k: None)
        return
    orig = ops.join

    def join(*a, **k):
        out, info = orig(*a, **k)
        pairs = info.join_pairs.clone()
        if fault == "half_batch":
            pairs[len(pairs) // 2:, 1] = -1
        else:
            pairs[0, 1] = (pairs[0, 1] + 1) % a[1].n_rows
        info.join_pairs = pairs
        return out, info
    monkeypatch.setattr(ops, "join", join)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_capture_fault_fails(fault, device, monkeypatch):
    _capture_fault(fault, monkeypatch)
    r = run("tpcdi_sf20.capture", device)
    assert not r["correct"], r["checks"]


def test_static_checks_pass():
    assert list(static_check.faults()) == []


@pytest.mark.parametrize("edit", [
    lambda b: b["workloads"][0].update(name="has space"),
    lambda b: b["end_to_end"][0].update(unit="tokens per second"),
    lambda b: b["per_layer"][0].update(moves="capture_rows_per_s"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["configs"][0].update(why="two\nlines"),
    lambda b: b["per_layer"][0].update(extra=1),
])
def test_static_checks_catch(edit):
    b = harness.bench()
    edit(b)
    assert list(static_check.bench_faults(b))


def test_no_forbidden_import(tmp_path, monkeypatch):
    """``repro`` and ``jax`` are caught by their whole top-level name;
    ``repro_torch`` is not."""
    monkeypatch.setattr(static_check, "HERE", tmp_path)
    monkeypatch.setattr(static_check, "ROOT", tmp_path.parent)
    (tmp_path / "a.py").write_text("import jax.numpy\nfrom repro.core import query\n")
    (tmp_path / "b.py").write_text("import repro_torch.core\n")
    assert len(list(static_check.import_faults())) == 2


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.01171875, -2.5, 3.14159], dtype=np.float32)
    want = torch.tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(round_bf16(x), want)


def test_reference_join_and_filter():
    """The reference's relations on a hand-made join: bag semantics, the
    left rows' order, then the right keys' stable order."""
    left = HostTable(["key", "l0"], np.array([[2, 1], [0, -1], [2, 5]], np.float32),
                     np.zeros((3, 2), bool))
    right = HostTable(["key", "r0"], np.array([[2, 0], [0, 0], [2, 0]], np.float32),
                      np.zeros((3, 2), bool))
    config = {"start": "t", "pipeline": [
        {"op": "join", "args": {"right": "s", "on": "key"}},
        {"op": "filter_gt", "args": {"col": "l0", "value": 0.0}}]}
    lin = run_pipeline(config, {"t": left, "s": right})
    (_, _, join), (_, _, filt) = lin.ops
    assert join[0][1].tolist() == [0, 0, 1, 2, 2] and join[1][1].tolist() == [0, 2, 1, 0, 2]
    assert join[1][2].tolist() == [0, -1, 1]
    assert filt[0][1].tolist() == [0, 1, 3, 4]
    assert lin.maps["s"][0].tolist() == [0, 2, 0, 2]


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("repro_torch_probe"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def test_tpcdi_tables_spec_shape():
    """DimTrade's 21 columns and DimSecurity's 15, every trade key among
    the security keys, many trades to one security."""
    from provbench.tables import tpcdi_join

    params = {"left": "trade", "right": "security", "left_rows": 3000, "right_rows": 3300,
              "left_cols": 21, "right_cols": 15}
    t = tpcdi_join.make(params, np.random.default_rng(SEED))
    trade, security = t["trade"], t["security"]
    assert (trade.n_cols, security.n_cols) == (21, 15)
    keys = trade.col("key")
    assert np.isin(keys, security.col("key")).all()
    assert len(np.unique(keys)) < len(keys)


def test_calls_drawn_as_they_fall_due():
    """The same seed draws the same calls; no call repeats an earlier one."""
    from provbench.streams import draw_call

    mix = harness.load_json(harness.HERE / "traffic" / "lineage-batch.json")
    sizes = {"s": (5000, 12), "out": (4000, 8)}

    def stream(seed):
        rng = np.random.default_rng(seed)
        return [draw_call(rng, mix, ["s"], sizes, "out", i) for i in range(64)]

    a, b = stream(SEED), stream(SEED)
    assert all(np.array_equal(x.rows, y.rows) for x, y in zip(a, b))
    assert len({x.rows.tobytes() for x in a}) == len(a)
