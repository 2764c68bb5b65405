"""The port's cost model, planner routing and calibration against ``repro``.

The routing defaults are ``repro``'s, so on the same pipelines
``CostModel.choose``, ``QuerySession.explain`` and the session's routing
counters (``walk`` / ``hopcache`` / ``fused_walk``) must be equal, for every
hop-cache backend.  Calibration fits the same constants from the same
measurements and writes them to the file it is given; no calibration file,
the port's or ``repro``'s, changes the port's routing.  Both packages'
active constants are reset to their defaults around each test.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import pipegen
from repro.core import calibrate as RCal
from repro.core import costmodel as RCM
from repro.core.hopcache import ComposedIndex as RComposed
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep import usecases as RU
from repro.provenance import QuerySession as RSession
from repro.provenance import prov as rprov
from repro_torch.core import calibrate as TCal
from repro_torch.core import costmodel as TCM
from repro_torch.core.hopcache import ComposedIndex
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep import usecases as TU
from repro_torch.kernels.ref import pack_bits
from repro_torch.provenance import QuerySession, prov
from test_torch_capture import build_merged
from test_torch_query import _diamond, id_map

BACKENDS = ("auto", "csr", "bitplane")


@pytest.fixture(autouse=True)
def default_constants(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "absent_repro.json"))
    RCM.reset_constants()
    TCM.reset_constants()
    yield
    RCM.reset_constants()
    TCM.reset_constants()


def _pipelines():
    for seed in range(4):
        base, specs = pipegen.random_specs(seed)
        r_idx, r_ids = pipegen.build_merged(base, specs)
        t_idx, _ = build_merged(base, specs)
        yield f"pipegen{seed}", r_idx, t_idx, "src", r_ids[-1]
    r_idx, r_sink = pipegen.diamond_pipeline(0)
    t_idx, _ = _diamond(0)
    yield "diamond", r_idx, t_idx, "src", r_sink
    r_idx = RIndex("german")
    r_sink = RU.run_german(r_idx, RU.make_german()).dataset_id
    t_idx = ProvenanceIndex("german", device="cpu")
    TU.run_german(t_idx, TU.make_german(device="cpu"))
    yield "german", r_idx, t_idx, "german_src", r_sink


PIPELINES = ["pipegen0", "pipegen1", "pipegen2", "pipegen3", "diamond", "german"]


def _pipeline(name):
    return next(p for p in _pipelines() if p[0] == name)[1:]


def _tup(stats):
    return None if stats is None else dataclasses.astuple(stats)


@pytest.mark.parametrize("name", PIPELINES)
def test_choose_matches_reference(name):
    r_idx, t_idx, src, sink = _pipeline(name)
    ids = id_map(r_idx, t_idx)
    r_cm, t_cm = RCM.CostModel(r_idx), TCM.CostModel(t_idx)
    for d in [d for d in ids if d in r_idx.datasets and r_idx.path_exists(src, d)]:
        assert [dataclasses.astuple(x) for x in t_cm.chain_stats(ids[src], ids[d])] == \
            [dataclasses.astuple(x) for x in r_cm.chain_stats(src, d)]
        t_rel, t_cost = t_cm.composed_estimate(ids[src], ids[d])
        r_rel, r_cost = r_cm.composed_estimate(src, d)
        assert (_tup(t_rel), t_cost) == (_tup(r_rel), r_cost)
        for n_probes, probe_rows in ((1, 1.0), (64, 8.0), (3, 0.5)):
            for budget in (None, 100):
                assert t_cm.choose(ids[src], ids[d], n_probes, probe_rows,
                                   budget_bytes=budget) == \
                    r_cm.choose(src, d, n_probes, probe_rows, budget_bytes=budget)


def test_chain_dp_and_gates_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        stats = [(int(rng.integers(1, 500)), int(rng.integers(1, 500))) for _ in range(5)]
        chain = []
        rows = stats[0][0]
        for _, cols in stats:
            nnz = int(rng.integers(0, rows * cols + 1))
            chain.append((rows, cols, nnz, bool(rng.random() < 0.5)))
            rows = cols
        t = [TCM.RelStats(*c) for c in chain]
        r = [RCM.RelStats(*c) for c in chain]
        for backend in ("csr", "bitplane", "auto"):
            assert TCM.plan_chain_stats(t, backend) == RCM.plan_chain_stats(r, backend)
        tv = TCM.extend_vs_recompose(t[0], t[1:])
        rv = RCM.extend_vs_recompose(r[0], r[1:])
        assert {k: v for k, v in tv.items() if k != "est"} == \
            {k: v for k, v in rv.items() if k != "est"}
        assert dataclasses.astuple(tv["est"]) == dataclasses.astuple(rv["est"])
        tc = TCM.cross_route_choose(t, 1e5, 16, 40, budget_bytes=1 << 20)
        rc = RCM.cross_route_choose(r, 1e5, 16, 40, budget_bytes=1 << 20)
        assert {k: v for k, v in tc.items() if k != "est"} == \
            {k: v for k, v in rc.items() if k != "est"}
    assert TCM.DENSITY_THRESHOLD == RCM.DENSITY_THRESHOLD
    for d in (0.0, 0.01, 0.06, 0.5):
        assert TCM.pick_backend(d) == RCM.pick_backend(d)


def _norm_explain(ex, ids=None):
    ex = dict(ex)
    ex.pop("plan")
    if "residency" in ex:
        ex["residency"] = [(tuple(ids.get(x, x) for x in r["pair"]) if ids else tuple(r["pair"]),
                            r["state"]) for r in ex["residency"]]
    return ex


def _plans(r_idx, t_idx, src, sink, rng):
    """(port builder, repro builder) pairs of record and co-query plans."""
    ids = id_map(r_idx, t_idx)
    n_src, n_dst = r_idx.datasets[src].n_rows, r_idx.datasets[sink].n_rows
    out = []
    for batch in (1, 4, 64):
        fwd = [sorted(set(rng.integers(0, n_src, 3).tolist())) for _ in range(batch)]
        bwd = [sorted(set(rng.integers(0, n_dst, 3).tolist())) for _ in range(batch)]
        out.append((prov(t_idx).source(ids[src]).rows_batch(fwd).forward().to(ids[sink]),
                    rprov(r_idx).source(src).rows_batch(fwd).forward().to(sink)))
        out.append((prov(t_idx).source(ids[sink]).rows_batch(bwd).backward().to(ids[src]),
                    rprov(r_idx).source(sink).rows_batch(bwd).backward().to(src)))
        mid = r_idx.ops[0].output_id
        out.append((prov(t_idx).source(ids[src]).rows_batch(fwd).co_contributory(
                        ids[src], via=ids[sink]),
                    rprov(r_idx).source(src).rows_batch(fwd).co_contributory(src, via=sink)))
        out.append((prov(t_idx).source(ids[sink]).rows_batch(bwd).co_dependency(
                        ids[src], ids[mid]),
                    rprov(r_idx).source(sink).rows_batch(bwd).co_dependency(src, mid)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", PIPELINES)
def test_session_routing_explain_and_answers_match_reference(name, backend):
    r_idx, t_idx, src, sink = _pipeline(name)
    ids = id_map(r_idx, t_idx)
    rs = RSession(r_idx, RComposed(r_idx, backend=backend, use_pallas=False))
    ts = QuerySession(t_idx, ComposedIndex(t_idx, backend=backend))
    assert ts.use_hopcache and ts.composed.backend == backend
    rng = np.random.default_rng(3)
    for tb, rb in _plans(r_idx, t_idx, src, sink, rng):
        tp, rp = tb.plan(), rb.plan()
        assert _norm_explain(ts.explain(tp), None) == _norm_explain(rs.explain(rp), ids)
        got, want = ts.run(tp), rs.run(rp)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert ts.counters == rs.counters
        t_st, r_st = ts.stats(), rs.stats()
        assert t_st["planner"] == r_st["planner"]
        assert {k: v for k, v in t_st["hopcache"].items() if k != "index"} == \
            {k: v for k, v in r_st["hopcache"].items() if k not in ("index", "spill")}
    assert ts.counters["hopcache"] > 0
    assert ts.explain(tp)["constants"]["source"] == "default"


def test_run_masks_routes_like_run():
    r_idx, t_idx, src, sink = _pipeline("pipegen1")
    ids = id_map(r_idx, t_idx)
    ts, rs = QuerySession(t_idx), RSession(r_idx, RComposed(r_idx, use_pallas=False))
    rows = [[0, 1], [2]]
    got = ts.run_masks(prov(t_idx).source(ids[src]).rows_batch(rows).forward().to(ids[sink]).plan())
    want = rs.run_masks(rprov(r_idx).source(src).rows_batch(rows).forward().to(sink).plan())
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts.counters == rs.counters
    with pytest.raises(ValueError):
        ts.run_masks(prov(t_idx).source(ids[sink]).transformations().plan())


def _synthetic_measurements(device):
    rng = np.random.default_rng(9)
    rows = []
    for n in (128, 256, 512):
        for d in (0.02, 0.1):
            w = n * n * ((n + 31) // 32)
            rows.append({"kind": "bitmatmul", "n": n, "density": d, "word_ops": w,
                         "t_ns": 3000.0 + 0.02 * w * (1 + 0.1 * rng.random())})
            f = d * d * n ** 3
            rows.append({"kind": "spmm", "n": n, "density": d, "flops": f,
                         "t_ns": 9000.0 + 1.5 * f * (1 + 0.1 * rng.random())})
    rows.append({"kind": "fused_walk", "n": 128, "hops": 4, "t_ns": 7000.0})
    return {"device": device, "rows": rows}


def test_fit_constants_matches_reference():
    meas = _synthetic_measurements("NVIDIA H100 80GB HBM3")
    got, want = TCal.fit_constants(meas), RCal.fit_constants(meas)
    for field in ("c_word_op", "c_spmm_flop", "c_spmm_overhead", "c_launch_overhead",
                  "density_threshold", "source", "device"):
        assert getattr(got, field) == getattr(want, field), field
    # the machine terms are the H100's, not repro's TPU defaults
    assert got.hbm_bw == 3.35e12 and got.peak_flops == 989e12 and got.link_bw == 450e9
    assert got.logic_word_ops == 132 * 64 * 1.98e9


def test_port_never_reads_the_reference_calibration(tmp_path, monkeypatch):
    r_file = tmp_path / "repro.json"
    RCal.save_constants(RCal.fit_constants(_synthetic_measurements("cpu")), str(r_file))
    monkeypatch.setenv("REPRO_CALIBRATION", str(r_file))
    TCM.reset_constants()
    TCM.CostModel(ProvenanceIndex("x", device="cpu"))
    assert TCM.active_constants().source == "default"
    assert TCM.active_constants() == TCM.Constants()


def test_port_calibration_file_is_keyed_by_device(tmp_path):
    path = str(tmp_path / "port.json")
    fitted = TCal.fit_constants(_synthetic_measurements("NVIDIA H100 80GB HBM3"))
    TCal.save_constants(fitted, path)
    assert set(json.loads(open(path).read())["devices"]) == {"NVIDIA H100 80GB HBM3"}
    # a lone foreign entry is not taken as this host's
    assert TCal.load_constants(path, device="cpu") is None
    # a second device's entry merges beside the first
    TCal.save_constants(dataclasses.replace(fitted, device="cpu", c_word_op=7.0), path)
    assert set(json.loads(open(path).read())["devices"]) == {"NVIDIA H100 80GB HBM3", "cpu"}
    got = TCal.load_constants(path, device="cpu")
    assert got.source == "calibrated" and got.device == "cpu" and got.c_word_op == 7.0
    assert TCal.load_constants(path, device="NVIDIA H100 80GB HBM3").c_word_op == fitted.c_word_op


def test_calibration_file_changes_no_route(tmp_path, monkeypatch):
    # a calibrated entry for this host, where an implicit reader would look:
    # the environment variable, then the home directory's cache
    fitted = TCal.fit_constants(_synthetic_measurements("cpu"))
    assert fitted.device == "cpu" and fitted != TCM.Constants()
    env_file = tmp_path / "env" / "calibration.json"
    TCal.save_constants(fitted, str(env_file))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(env_file))
    home = tmp_path / "home"
    TCal.save_constants(fitted, str(home / ".cache" / "repro_torch" / "calibration.json"))
    monkeypatch.setenv("HOME", str(home))
    TCM.reset_constants()
    t_idx, t_sink = _diamond(0)
    TCM.CostModel(t_idx)
    assert TCM.active_constants() == TCM.Constants()
    plan = prov(t_idx).source("src").rows_batch([[0], [1, 2]]).forward().to(t_sink).plan()
    assert QuerySession(t_idx).explain(plan)["constants"]["source"] == "default"


def test_microbench_on_the_host_fits_and_persists(tmp_path):
    c = TCal.calibrate(path=str(tmp_path / "cal.json"), device="cpu")
    assert c.source == "calibrated" and c.device == "cpu" and c.c_word_op > 0
    assert 1e-4 <= c.density_threshold <= 0.5
    assert TCM.active_constants().source == "default"
    assert TCal.load_constants(str(tmp_path / "cal.json"), "cpu").c_word_op == c.c_word_op


@pytest.mark.parametrize("n,density", [(1, 1.0), (33, 0.1), (100, 0.02)])
def test_microbench_relations_are_distinct_links_packed_exactly(n, density):
    gen = torch.Generator().manual_seed(3)
    rows, cols = TCal._random_pairs(gen, n, density, torch.device("cpu"))
    assert torch.unique(rows * n + cols).numel() == rows.numel()
    dense = torch.zeros((n, n), dtype=torch.bool)
    dense[rows, cols] = True
    assert torch.equal(TCal._pairs_bitplane(rows, cols, n), pack_bits(dense))


def test_microbench_times_back_to_back_calls():
    calls = []
    t = TCal._median_ns(lambda: calls.append(1), 3, torch.device("cpu"))
    assert t > 0 and len(calls) == 1 + 3 * 100
