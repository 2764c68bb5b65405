"""The port's composed hop-cache against the JAX package's, entry for entry.

The same pipelines are built in both packages (``pipegen`` spec replays,
the diamond, a forced-COO capture and the German use case); a
``ComposedIndex`` per package and backend (``auto``, ``csr``,
``bitplane``) then composes every ``relation(src, dst)``, probes it in both
directions and reports its ``stats()``.  Relations, backends, probe answers
and counters (hits, misses, conversions, extends, recomposes, evictions,
entries per backend, bytes) must be equal.  The port runs on the CPU, where
its ``bitmatmul`` entry takes the plain version; ``repro`` runs its host
path.  Datasets are aligned by op position.
"""
import numpy as np
import pytest
import torch

import pipegen
from repro.core.capture import force_coo_capture as r_force_coo
from repro.core.hopcache import ComposedIndex as RComposed
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.core.provtensor import unpack_bitplane as r_unpack
from repro.dataprep import usecases as RU
from repro.dataprep.tracked import TrackedTable as RTracked
from repro_torch.core.capture import force_coo_capture
from repro_torch.core.carry import index_from_numpy
from repro_torch.core.hopcache import ComposedIndex, transpose_bitplane
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import pack_bitplane, unpack_bitplane
from repro_torch.core.query import rows_per_probe
from repro_torch.dataprep import usecases as TU
from repro_torch.dataprep.tracked import TrackedTable as TTracked
from repro_torch.kernels import ops as TK
from test_torch_capture import apply_spec, build_merged
from test_torch_query import _diamond, id_map

BACKENDS = ("auto", "csr", "bitplane")
STAT_KEYS = ("entries", "entries_csr", "entries_bitplane", "entries_structured", "bytes",
             "hits", "misses", "evictions", "conversions", "extends", "recomposes")


def r_dense(ci, src, dst):
    rel, backend = ci.relation(src, dst), ci.relation_backend(src, dst)
    rows, cols = ci.index.datasets[src].n_rows, ci.index.datasets[dst].n_rows
    if backend == "structured":
        out = np.zeros((rows, cols), bool)
        d = np.flatnonzero(rel >= 0)
        out[rel[d], d] = True
        return out, backend
    if backend == "csr":
        return rel.toarray() > 0, backend
    return r_unpack(rel, cols), backend


def t_dense(ci, src, dst):
    rel, backend = ci.relation(src, dst), ci.relation_backend(src, dst)
    rows, cols = ci.index.datasets[src].n_rows, ci.index.datasets[dst].n_rows
    if backend == "structured":
        assert rel.dtype == torch.int32
        out = torch.zeros((rows, cols), dtype=torch.bool)
        d = torch.nonzero(rel >= 0).reshape(-1)
        out[rel[d].long(), d] = True
        return out.numpy(), backend
    if backend == "csr":
        assert rel.crow_indices().dtype == torch.int32 and rel.col_indices().dtype == torch.int32
        return rel.to_dense().numpy() > 0, backend
    assert rel.dtype == torch.int32
    return unpack_bitplane(rel, cols).numpy(), backend


def same_stats(t_ci, r_ci):
    got, want = t_ci.stats(), r_ci.stats()
    assert {k: got[k] for k in STAT_KEYS} == {k: want[k] for k in STAT_KEYS}


def compare(r_idx, t_idx, backend, seed, budget=64 << 20, pairs=None):
    """Compose and probe every (source, reachable dataset) pair in both
    packages, in the same order, and compare after each step."""
    ids = id_map(r_idx, t_idx)
    r_ci = RComposed(r_idx, memory_budget_bytes=budget, backend=backend, use_pallas=False)
    t_ci = ComposedIndex(t_idx, memory_budget_bytes=budget, backend=backend)
    rng = np.random.default_rng(seed)
    if pairs is None:
        pairs = [(s, d) for s in r_idx.sources() for d in ids
                 if d in r_idx.datasets and r_idx.path_exists(s, d)]
    for src, dst in pairs:
        got, got_b = t_dense(t_ci, ids[src], ids[dst])
        want, want_b = r_dense(r_ci, src, dst)
        assert got_b == want_b, (src, dst)
        np.testing.assert_array_equal(got, want)
        n_src, n_dst = r_idx.datasets[src].n_rows, r_idx.datasets[dst].n_rows
        fwd = rng.random((5, n_src)) < 0.3
        bwd = rng.random((5, n_dst)) < 0.3
        np.testing.assert_array_equal(
            t_ci.probe_forward(torch.from_numpy(fwd), ids[src], ids[dst]).numpy(),
            r_ci.probe_forward(fwd, src, dst))
        np.testing.assert_array_equal(
            t_ci.probe_backward(torch.from_numpy(bwd), ids[dst], ids[src]).numpy(),
            r_ci.probe_backward(bwd, dst, src))
        same_stats(t_ci, r_ci)
    return r_ci, t_ci


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(6))
def test_pipegen_relations_probes_and_stats_match(seed, backend):
    base, specs = pipegen.random_specs(seed)
    r_idx, _ = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    compare(r_idx, t_idx, backend, seed)


@pytest.mark.parametrize("backend", BACKENDS)
def test_diamond_sums_over_both_paths(backend):
    r_idx, _ = pipegen.diamond_pipeline(0)
    t_idx, _ = _diamond(0)
    compare(r_idx, t_idx, backend, 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forced_coo_capture_composes_like_reference(backend):
    base, specs = pipegen.random_specs(3)
    with r_force_coo():
        r_idx, _ = pipegen.build_merged(base, specs)
    with force_coo_capture():
        t_idx, _ = build_merged(base, specs)
    r_ci, t_ci = compare(r_idx, t_idx, backend, 3)
    if backend == "auto":
        assert t_ci.stats()["entries_csr"] + t_ci.stats()["entries_bitplane"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_german_composes_like_reference(backend):
    r_idx = RIndex("german")
    RU.run_german(r_idx, RU.make_german())
    t_idx = ProvenanceIndex("german", device="cpu")
    TU.run_german(t_idx, TU.make_german(device="cpu"))
    compare(r_idx, t_idx, backend, 7)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("budget", [0, 600, 4000])
def test_small_budget_evicts_like_reference(backend, budget):
    base, specs = pipegen.random_specs(1)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, _ = build_merged(base, specs)
    # far pairs first, then near ones, then the far ones again
    order = [("src", d) for d in reversed(r_ids[1:])] + [("src", d) for d in r_ids[1:]]
    _, t_ci = compare(r_idx, t_idx, backend, 1, budget=budget, pairs=order)
    assert t_ci.stats()["entries"] <= 1 or t_ci.stats()["bytes"] <= budget


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 2, 4])
def test_appended_ops_extend_warm_relations(seed, backend):
    base, specs = pipegen.random_specs(seed)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    r_ci = RComposed(r_idx, backend=backend, use_pallas=False)
    t_ci = ComposedIndex(t_idx, backend=backend)
    r_dense(r_ci, "src", r_ids[-1])
    t_dense(t_ci, "src", t_ids[-1])
    same_stats(t_ci, r_ci)
    r_cur = RTracked(r_idx.datasets[r_ids[-1]].table, r_idx, r_ids[-1])
    t_cur = TTracked(t_idx.datasets[t_ids[-1]].table, t_idx, t_ids[-1])
    for spec in (("filter", -0.5), ("scale",), ("undersample", 0.7, 3)):
        r_cur = pipegen.apply_spec(r_cur, spec, r_idx)
        t_cur = apply_spec(t_cur, spec, t_idx)
        got, _ = t_dense(t_ci, "src", t_cur.dataset_id)
        want, _ = r_dense(r_ci, "src", r_cur.dataset_id)
        np.testing.assert_array_equal(got, want)
        same_stats(t_ci, r_ci)
    if backend == "auto":
        assert t_ci.stats()["extends"] >= 3


def test_carried_index_composes_like_reference():
    base, specs = pipegen.random_specs(5)
    r_idx, r_ids = pipegen.build_merged(base, specs)
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
    carried = index_from_numpy(datasets, ops, device="cpu")
    for backend in BACKENDS:
        compare(r_idx, carried, backend, 5)


def test_backend_default_is_auto_and_spill_raises():
    t_idx, _ = _diamond(5)
    assert ComposedIndex(t_idx).backend == "auto"
    assert t_idx.composed() is t_idx.composed()
    with pytest.raises(ValueError):
        t_idx.composed(memory_budget_bytes=1)
    spilled = ComposedIndex(t_idx, spill=True)
    st = spilled.stats()
    assert (st["spills"], st["rehydrations"], st["spilled_entries"]) == (0, 0, 0)
    assert st["spill"]["entries"] == 0 and "spill" not in ComposedIndex(t_idx).stats()
    with pytest.raises(ValueError):
        ComposedIndex(t_idx, backend="dense")


def test_residency_contains_and_invalidation():
    base, specs = pipegen.random_specs(2)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    r_ci = RComposed(r_idx, use_pallas=False)
    t_ci = ComposedIndex(t_idx)
    assert t_ci.residency("src", t_ids[-1]) is None and not t_ci.contains("src", t_ids[-1])
    r_ci.relation("src", r_ids[-1])
    t_ci.relation("src", t_ids[-1])
    assert t_ci.residency("src", t_ids[-1]) == "ram" and t_ci.contains("src", t_ids[-1])
    ids = id_map(r_idx, t_idx)
    for mid in r_ids[1:]:
        got = t_ci.stale_entries([ids[mid]])
        want = r_ci.stale_entries([mid])
        assert sorted(got) == sorted((ids[s], ids[d], r) for s, d, r in want)
    got = t_ci.invalidate_datasets([ids[r_ids[2]]])
    want = r_ci.invalidate_datasets([r_ids[2]])
    assert sorted(got) == sorted((ids[s], ids[d], r) for s, d, r in want)
    same_stats(t_ci, r_ci)


def _probe_stack(probes, n):
    """A ``(B, n)`` bool mask stack, one row per probe set."""
    masks = torch.zeros((len(probes), n), dtype=torch.bool)
    for b, rows in enumerate(probes):
        masks[b, list(rows)] = True
    return masks


def test_q_helpers_match_reference():
    """``repro``'s Q1/Q2/Q10/Q11 hop-cache helpers, spelled as the port's
    ``probe_forward`` / ``probe_backward`` and ``rows_per_probe``."""
    base, specs = pipegen.random_specs(4)
    r_idx, r_ids = pipegen.build_merged(base, specs)
    t_idx, t_ids = build_merged(base, specs)
    r_ci = RComposed(r_idx, use_pallas=False)
    t_ci = ComposedIndex(t_idx)
    rng = np.random.default_rng(4)
    n_src, n_dst = r_idx.datasets["src"].n_rows, r_idx.datasets[r_ids[-1]].n_rows
    fwd, bwd = pipegen.row_probes(rng, n_src), pipegen.row_probes(rng, n_dst)
    fwd_m, bwd_m = _probe_stack(fwd, n_src), _probe_stack(bwd, n_dst)

    def same(got_masks, want):
        got = rows_per_probe(got_masks)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)

    same(t_ci.probe_forward(fwd_m, "src", t_ids[-1]), r_ci.q1_forward("src", fwd, r_ids[-1]))
    same(t_ci.probe_backward(bwd_m, t_ids[-1], "src"), r_ci.q2_backward(r_ids[-1], bwd, "src"))
    same(t_ci.probe_forward(fwd_m[2:3], "src", t_ids[-1]),
         [r_ci.q1_forward("src", fwd[2], r_ids[-1])])
    # Q10: forward to the meeting dataset, then back to d2
    via = t_ci.probe_forward(fwd_m, "src", t_ids[-1])
    same(t_ci.probe_backward(via, t_ids[-1], t_ids[1]),
         r_ci.q10_co_contributory("src", fwd, r_ids[1], r_ids[-1]))
    # Q11: back to the shared ancestor d1, then forward to d3
    anc = t_ci.probe_backward(bwd_m, t_ids[-1], "src")
    same(t_ci.probe_forward(anc, "src", t_ids[2]),
         r_ci.q11_co_dependency(r_ids[-1], bwd, "src", r_ids[2]))


def test_bitplane_backend_composes_through_the_bitmatmul_entry():
    """A linear chain of K ops in the bitplane backend: K - 1 compositions
    on the first query, then one launch per batched probe."""
    t_idx = ProvenanceIndex("german", device="cpu")
    sink = TU.run_german(t_idx, TU.make_german(device="cpu")).dataset_id
    src = t_idx.sources()[0]
    ci = ComposedIndex(t_idx, backend="bitplane")
    k = len(t_idx.ops)
    masks = torch.zeros((4, t_idx.datasets[src].n_rows), dtype=torch.bool)
    masks[:, :3] = True
    TK.reset_launch_counts()
    ci.probe_forward(masks, src, sink)
    assert TK.launch_counts() == {"bitmatmul": k}
    back = torch.zeros((4, t_idx.datasets[sink].n_rows), dtype=torch.bool)
    back[:, 5] = True
    ci.probe_backward(back, sink, src)
    assert TK.launch_counts() == {"bitmatmul": k + 1}
    TK.reset_launch_counts()


@pytest.mark.parametrize("rows,cols", [(1, 1), (5, 33), (40, 64), (70, 100)])
def test_transpose_bitplane(rows, cols):
    dense = torch.from_numpy(np.random.default_rng(rows).random((rows, cols)) < 0.3)
    got = transpose_bitplane(pack_bitplane(dense), cols)
    assert torch.equal(got, pack_bitplane(dense.T.contiguous()))


# ---------------------------------------------------------------------------
# compose.py: chain composition, the dims DP and the closed forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("coo", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_compose_chain_and_lineage_match_reference(seed, coo):
    from contextlib import nullcontext

    from repro.core import compose as RC
    from repro_torch.core import compose as TC

    base, specs = pipegen.random_specs(seed)
    with (r_force_coo() if coo else nullcontext()):
        r_idx, r_ids = pipegen.build_merged(base, specs)
    with (force_coo_capture() if coo else nullcontext()):
        t_idx, t_ids = build_merged(base, specs)
    for r_dst, t_dst in zip(r_ids, t_ids):
        for optimize in (True, False):
            got = TC.compose_chain(t_idx, "src", t_dst, optimize=optimize)
            want = RC.compose_chain(r_idx, "src", r_dst, use_pallas=False, optimize=optimize)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(TC.dataset_lineage(t_idx, "src", t_dst).numpy(),
                                      RC.dataset_lineage(r_idx, "src", r_dst, use_pallas=False))
        chain_t = TC.path_tensors(t_idx, "src", t_dst)
        chain_r = RC.path_tensors(r_idx, "src", r_dst)
        g_t, g_r = TC.chain_gather(chain_t), RC.chain_gather(chain_r)
        assert (g_t is None) == (g_r is None)
        if g_t is not None:
            np.testing.assert_array_equal(g_t.numpy(), g_r)


def test_plan_chain_matches_reference():
    from repro.core import compose as RC
    from repro_torch.core import compose as TC

    rng = np.random.default_rng(0)
    for n in range(1, 7):
        p = rng.integers(1, 500, n + 1).tolist()
        dims = [(p[i], p[i + 1]) for i in range(n)]
        assert TC.plan_chain(dims) == RC.plan_chain(dims)


@pytest.mark.parametrize("rows,mid,dst", [(5, 9, 12), (40, 33, 70), (3, 1, 4)])
def test_extend_tail_matches_reference(rows, mid, dst):
    import scipy.sparse as sp

    from repro.core import compose as RC
    from repro.core.provtensor import pack_bitplane as r_pack
    from repro_torch.core import compose as TC

    rng = np.random.default_rng(rows + mid + dst)
    dense = rng.random((rows, mid)) < 0.3
    g = rng.integers(-1, mid, dst).astype(np.int32)
    want = RC.extend_tail(sp.csr_matrix(dense.astype(np.float32)), g, "csr").toarray() > 0
    src, cols = np.nonzero(dense)
    rel = TC.csr_from_pairs(torch.from_numpy(src), torch.from_numpy(cols), rows, mid)
    got = TC.extend_tail(rel, torch.from_numpy(g), "csr")
    assert got.crow_indices().dtype == torch.int32
    np.testing.assert_array_equal(got.to_dense().numpy() > 0, want)
    plane = r_pack(dense)
    got = TC.extend_tail(torch.from_numpy(plane.view(np.int32).copy()), torch.from_numpy(g),
                         "bitplane", n_mid=mid)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  RC.extend_tail(plane, g, "bitplane", n_mid=mid))
    with pytest.raises(ValueError):
        TC.extend_tail(got, torch.from_numpy(g), "dense")
