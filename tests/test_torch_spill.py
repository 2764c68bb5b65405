"""The port's spill tier against the JAX package's (twins of test_spill.py).

Three layers, each held to ``repro`` on the same inputs:

* :class:`repro_torch.core.spill.SpillStore` — the RSPL1 segmented log:
  round trips, overwrite/delete, rotation and GC, the disk budget, the
  ephemeral root; the same puts give byte-identical segment files in both
  packages;
* :class:`repro_torch.core.spill.TensorSpiller`
  (``ProvenanceIndex(spill=...)``) — budget-bounded residency, payload
  strip/restore, fault-back answers and counters equal to ``repro``'s
  with the same budget, LRU discipline, the immutable re-spill, the
  ``spill=`` forms, and ``recompute_rows`` through a fault;
* :class:`repro_torch.core.hopcache.ComposedIndex` with ``spill=`` —
  every backend evicts and faults back byte for byte, residency states,
  eager extension through spilled tensors, counters and store bytes equal
  to ``repro``'s.

Everything runs on the CPU; comparisons are exact.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.capture import restore_payload as r_restore
from repro.core.capture import strip_payload as r_strip
from repro.core.hopcache import ComposedIndex as RComposed
from repro.core.opcat import AttrMap as RAttrMap
from repro.core.opcat import CaptureInfo as RInfo
from repro.core.opcat import OpCategory as ROpCategory
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.core.recompute import recompute_rows as r_recompute
from repro.core.spill import SpillPolicy as RPolicy
from repro.core.spill import SpillStore as RStore
from repro.dataprep.table import Table as RTable
from repro_torch.core import capture
from repro_torch.core.capture import restore_payload, strip_payload
from repro_torch.core.hopcache import ComposedIndex
from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import (
    ProvTensor,
    append_tensor,
    haugment_tensor,
    hreduce_tensor,
    identity_tensor,
    join_tensor,
    unpack_bitplane,
)
from repro_torch.core.recompute import recompute_rows
from repro_torch.core.spill import (
    SpillPolicy,
    SpillStore,
    _TensorFault,
    device_tensor,
    host_array,
    resolve_spill,
)
from repro_torch.dataprep.table import Table

CPU = "cpu"
SPILL_KEYS = ("resident_ops", "spilled_ops", "resident_bytes", "budget_bytes", "spills",
              "rehydrations")
STORE_KEYS = ("entries", "segments", "live_bytes", "disk_bytes", "dead_bytes", "writes",
              "reads", "bytes_written", "bytes_read", "drops")
HOP_KEYS = ("entries", "bytes", "hits", "misses", "evictions", "conversions", "extends",
            "recomposes", "spills", "rehydrations", "spilled_entries")


# ===========================================================================
# One filter chain, recorded into both packages from the same numpy draws
# ===========================================================================
def _columns(n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}


def _kept_chain(n, hops, seed):
    rng = np.random.default_rng(seed + 1)
    out, cn = [], n
    for _ in range(hops):
        kept = np.flatnonzero(rng.random(cn) > 0.15).astype(np.int32)
        if len(kept) == 0:
            kept = np.array([0], dtype=np.int32)
        out.append(kept)
        cn = len(kept)
    return out


def _filter_chains(n=64, hops=6, seed=0, spill=None, r_spill=None):
    """The same linear filter chain in both packages: (repro index, port
    index, sink id); every intermediate non-materialized."""
    r_idx = RIndex("spillchain", spill=r_spill)
    t_idx = ProvenanceIndex("spillchain", device=CPU, spill=spill)
    r_idx.add_source("d0", RTable.from_columns(_columns(n, seed)))
    t_idx.add_source("d0", Table.from_columns(_columns(n, seed), device=CPU))
    cur, cn = "d0", n
    for i, kept in enumerate(_kept_chain(n, hops, seed)):
        out = f"d{i + 1}"
        cols = _columns(len(kept), seed + 2 + i)
        r_idx.record([cur], out, RTable.from_columns(cols),
                     RInfo(op_name=f"f{i}", category=ROpCategory.HREDUCE, contextual=False,
                           n_out=len(kept), n_in=[cn], kept_rows=kept.copy(),
                           attr_maps=[RAttrMap("identity")]))
        t_idx.record([cur], out, Table.from_columns(cols, device=CPU),
                     CaptureInfo(op_name=f"f{i}", category=OpCategory.HREDUCE,
                                 contextual=False, n_out=len(kept), n_in=[cn],
                                 kept_rows=torch.from_numpy(kept.copy()),
                                 attr_maps=[AttrMap("identity")]))
        cur, cn = out, len(kept)
    return r_idx, t_idx, cur


def _append_filter(r_idx, t_idx, cur, out, rng, keep=0.9):
    """One more filter onto ``cur`` in both packages."""
    cn = r_idx.datasets[cur].n_rows
    kept = np.flatnonzero(rng.random(cn) < keep).astype(np.int32)
    cols = _columns(len(kept), len(kept))
    r_idx.record([cur], out, RTable.from_columns(cols),
                 RInfo(op_name=out, category=ROpCategory.HREDUCE, contextual=False,
                       n_out=len(kept), n_in=[cn], kept_rows=kept.copy(),
                       attr_maps=[RAttrMap("identity")]))
    t_idx.record([cur], out, Table.from_columns(cols, device=CPU),
                 CaptureInfo(op_name=out, category=OpCategory.HREDUCE, contextual=False,
                             n_out=len(kept), n_in=[cn], kept_rows=torch.from_numpy(kept.copy()),
                             attr_maps=[AttrMap("identity")]))
    return out


def _segments(root):
    return {f: open(os.path.join(root, f), "rb").read() for f in sorted(os.listdir(root))}


def _dense(rel, backend, rows, cols):
    """A relation of either package as a dense bool numpy matrix."""
    if isinstance(rel, torch.Tensor):
        if rel.layout == torch.sparse_csr:
            return rel.to_dense().numpy() > 0
        if backend == "bitplane":
            return unpack_bitplane(rel, cols).numpy()
        out = np.zeros((rows, cols), bool)
        g = rel.numpy()
        d = np.flatnonzero(g >= 0)
        out[g[d], d] = True
        return out
    if hasattr(rel, "toarray"):
        return rel.toarray() > 0
    if backend == "bitplane":
        from repro.core.provtensor import unpack_bitplane as r_unpack

        return r_unpack(rel, cols)
    out = np.zeros((rows, cols), bool)
    d = np.flatnonzero(rel >= 0)
    out[rel[d], d] = True
    return out


def _same_entries(t_store, r_store, ids):
    """The two stores hold the same entries under the same keys (dataset
    ids mapped through ``ids``), with equal arrays.  A CSR
    entry stores the same ``indptr`` and ``data`` and, row by row, the same
    column set: the order of columns within a row is whatever each
    library's sparse product leaves (scipy does not sort them), so segment
    bytes of CSR entries are not compared."""
    r_keys = {k[:2] + (ids[k[2]], ids[k[3]]): k for k in r_store.keys()}
    assert sorted(t_store.keys()) == sorted(r_keys)
    for key in t_store.keys():
        t_meta, t_arr = t_store.get(key)
        r_meta, r_arr = r_store.get(r_keys[key])
        assert t_meta == r_meta and sorted(t_arr) == sorted(r_arr)
        if t_meta["backend"] != "csr":
            for name in t_arr:
                np.testing.assert_array_equal(t_arr[name], r_arr[name])
            continue
        for name in ("indptr", "data"):
            assert t_arr[name].dtype == r_arr[name].dtype
            np.testing.assert_array_equal(t_arr[name], r_arr[name])
        ptr = t_arr["indptr"]
        for i in range(len(ptr) - 1):
            np.testing.assert_array_equal(np.sort(t_arr["indices"][ptr[i]:ptr[i + 1]]),
                                          np.sort(r_arr["indices"][ptr[i]:ptr[i + 1]]))


# ===========================================================================
# SpillStore: the on-disk segmented log
# ===========================================================================
class TestSpillStore:
    def test_roundtrip_byte_identical(self, tmp_path):
        st = SpillStore(str(tmp_path / "log"))
        arrays = {
            "a": np.arange(100, dtype=np.int32),
            "b": np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32),
            "c": np.array([], dtype=np.int64),
            "d": np.packbits(np.ones(65, dtype=np.uint8)).astype(np.uint8),
        }
        st.put(("op", "p", 0), arrays, {"kind": "test", "n": 100})
        meta, got = st.get(("op", "p", 0))
        assert meta["kind"] == "test" and meta["n"] == 100
        assert set(got) == set(arrays)
        for k in arrays:
            assert got[k].dtype == arrays[k].dtype and got[k].shape == arrays[k].shape
            np.testing.assert_array_equal(got[k], arrays[k])

    def test_packed_words_cross_as_uint32(self, tmp_path):
        words = torch.tensor([[-1, 0, 1 << 30], [-(1 << 31), 7, 3]], dtype=torch.int32)
        st = SpillStore(str(tmp_path / "log"))
        st.put("w", {"plane": host_array(words, packed=True)}, {})
        _, got = st.get("w")
        assert got["plane"].dtype == np.uint32 and not got["plane"].flags.writeable
        back = device_tensor(got["plane"], CPU)
        assert back.dtype == torch.int32 and torch.equal(back, words)
        back[0, 0] = 5                                # a writable copy, not the mapping
        assert st.get("w")[1]["plane"][0, 0] == 0xFFFFFFFF

    def test_overwrite_and_delete(self, tmp_path):
        st = SpillStore(str(tmp_path / "log"))
        st.put("k", {"a": np.arange(4)}, {})
        st.put("k", {"a": np.arange(8)}, {})        # overwrite = delete + append
        _, got = st.get("k")
        assert len(got["a"]) == 8
        assert st.stats()["dead_bytes"] > 0
        st.delete("k")
        assert "k" not in st
        with pytest.raises(KeyError):
            st.get("k")

    def test_segment_rotation_and_gc(self, tmp_path):
        st = SpillStore(str(tmp_path / "log"), segment_bytes=4096)
        for i in range(16):
            st.put(i, {"a": np.arange(320, dtype=np.int32)}, {})
        assert st.stats()["segments"] > 1
        for i in range(16):
            st.delete(i)
        assert st.stats()["segments"] <= 1 and st.stats()["entries"] == 0

    def test_disk_budget_drops_oldest(self, tmp_path):
        st = SpillStore(str(tmp_path / "log"), segment_bytes=2048, disk_budget_bytes=6144)
        for i in range(24):
            st.put(i, {"a": np.arange(128, dtype=np.int64)}, {})
        assert st.stats()["disk_bytes"] <= 6144 + 2048
        assert st.stats()["drops"] > 0
        assert 23 in st and 0 not in st

    def test_ephemeral_root_cleanup(self):
        st = SpillStore()
        root = st.stats()["root"]
        st.put("k", {"a": np.arange(4)}, {})
        st.close()
        assert not os.path.exists(root)

    def test_segments_byte_identical_to_reference(self, tmp_path):
        """The same puts, deletes and rotations give the same segment files
        and the same counters in both packages."""
        rng = np.random.default_rng(3)
        ours = SpillStore(str(tmp_path / "t"), segment_bytes=3000)
        theirs = RStore(str(tmp_path / "r"), segment_bytes=3000)
        for i in range(12):
            arrays = {"g": rng.integers(-1, 50, size=int(rng.integers(1, 200))).astype(np.int32),
                      "w": rng.integers(0, 1 << 32, size=(3, 4), dtype=np.uint64)
                      .astype(np.uint32)}
            meta = {"n_out": i, "slots": [{"kind": "gather"}], "payload_bytes": 4 * i}
            for st in (ours, theirs):
                st.put(("op", "p", i), arrays, meta)
            if i % 4 == 3:
                for st in (ours, theirs):
                    st.delete(("op", "p", i - 2))
        assert _segments(ours.root) == _segments(theirs.root)
        assert {k: ours.stats()[k] for k in STORE_KEYS} == \
            {k: theirs.stats()[k] for k in STORE_KEYS}


# ===========================================================================
# ProvTensor payload round-trip and payload strip/restore
# ===========================================================================
def _tensor_kinds():
    rng = np.random.default_rng(7)
    kept = np.sort(rng.choice(40, size=25, replace=False)).astype(np.int32)
    src = rng.integers(-1, 40, size=30).astype(np.int32)
    pairs = np.stack([rng.integers(-1, 12, 20), rng.integers(-1, 9, 20)], axis=1).astype(np.int32)
    pairs[(pairs[:, 0] < 0) & (pairs[:, 1] < 0), 0] = 0
    links = np.stack([np.repeat(np.arange(10), 2), rng.integers(0, 33, 20)],
                     axis=1).astype(np.int32)
    t = torch.from_numpy
    return {
        "identity": identity_tensor(17, device=CPU),
        "hreduce": hreduce_tensor(t(kept), 40),
        "haugment": haugment_tensor(t(src), 40),
        "join": join_tensor(t(pairs), 12, 9),
        "append": append_tensor(11, 6, device=CPU),
        "coo_links": ProvTensor(n_out=10, n_in=(33,), coo=t(links)),
    }


@pytest.mark.parametrize("kind", list(_tensor_kinds()))
def test_payload_roundtrip(kind, tmp_path):
    t = _tensor_kinds()[kind]
    meta, arrays = t.to_payload()
    st = SpillStore(str(tmp_path / "log"))
    st.put("t", {k: host_array(a) for k, a in arrays.items()}, meta)
    meta2, arrays2 = st.get("t")
    back = ProvTensor.from_payload(meta2, {k: device_tensor(a, CPU) for k, a in arrays2.items()},
                                   device=CPU)
    assert back.n_out == t.n_out and back.n_in == t.n_in and back.structured == t.structured
    assert torch.equal(back.coo, t.coo)
    for a, b in ((back.fwd(0), t.fwd(0)), (back.bwd(0), t.bwd(0))):
        assert torch.equal(a.row_ptr, b.row_ptr) and torch.equal(a.col_idx, b.col_idx)
    assert back.as_coo().structured is False and torch.equal(back.as_coo().coo, t.coo)
    assert back.slot_shape(0) == (t.n_in[0], t.n_out) and back.resident() is back
    # CSR.neighbors row by row, against repro's tensor built from the payload
    from repro.core.provtensor import ProvTensor as RTensor

    r = RTensor.from_payload(meta, {k: a.numpy() for k, a in arrays.items()})
    for half in ("fwd", "bwd"):
        ours, theirs = getattr(back, half)(0), getattr(r, half)(0)
        for q in range(ours.n_rows):
            np.testing.assert_array_equal(ours.neighbors(q).numpy(), theirs.neighbors(q))


def test_payload_strip_restore_aliases():
    src = np.array([0, -1, 2, 1, -1], dtype=np.int32)
    info = CaptureInfo(op_name="g", category=OpCategory.HAUGMENT, contextual=False,
                       n_out=5, n_in=[3], src_rows=torch.from_numpy(src),
                       attr_maps=[AttrMap("identity")])
    t = capture.build_tensor(info, device=CPU)
    strip_payload(info)
    assert info.src_rows is None and info._spill_stripped == ("src_rows",)
    restore_payload(info, t)
    np.testing.assert_array_equal(info.src_rows.numpy(), src)
    assert info._spill_stripped == ()
    links = np.array([[0, 1], [0, 2], [1, 0]], dtype=np.int32)
    info2 = CaptureInfo(op_name="pack", category=OpCategory.HAUGMENT, contextual=False,
                        n_out=2, n_in=[3], links=torch.from_numpy(links),
                        attr_maps=[AttrMap("identity")])
    t2 = capture.build_tensor(info2, device=CPU)
    strip_payload(info2)
    assert info2._spill_stripped == ("links",)
    restore_payload(info2, t2)
    assert info2.src_rows is None
    np.testing.assert_array_equal(info2.links.numpy(), links)
    # a join: both gather slots come back as the (n, 2) pairs, as in repro
    pairs = np.array([[0, 1], [2, -1], [-1, 0]], dtype=np.int32)
    info3 = CaptureInfo(op_name="join", category=OpCategory.JOIN, contextual=False, n_out=3,
                        n_in=[3, 2], join_pairs=torch.from_numpy(pairs),
                        attr_maps=[AttrMap("identity"), AttrMap("identity")])
    r_info3 = RInfo(op_name="join", category=ROpCategory.JOIN, contextual=False, n_out=3,
                    n_in=[3, 2], join_pairs=pairs.copy(),
                    attr_maps=[RAttrMap("identity"), RAttrMap("identity")])
    from repro.core import capture as rcapture

    t3, rt3 = capture.build_tensor(info3, device=CPU), rcapture.build_tensor(r_info3)
    strip_payload(info3)
    r_strip(r_info3)
    assert info3._spill_stripped == r_info3._spill_stripped == ("join_pairs",)
    restore_payload(info3, t3)
    r_restore(r_info3, rt3)
    np.testing.assert_array_equal(info3.join_pairs.numpy(), r_info3.join_pairs)


# ===========================================================================
# TensorSpiller: bounded residency + transparent fault-back
# ===========================================================================
def _spill_stats(idx):
    sp = idx.stats()["spill"]
    return {k: sp[k] for k in SPILL_KEYS}, {k: sp["store"][k] for k in STORE_KEYS}


class TestTensorSpiller:
    def test_budget_bounds_residency(self):
        budget = 2048
        r_idx, t_idx, _ = _filter_chains(n=512, hops=10, spill=SpillPolicy(budget_bytes=budget),
                                         r_spill=RPolicy(budget_bytes=budget))
        sp = t_idx.stats()["spill"]
        assert sp["spills"] > 0 and sp["resident_bytes"] <= budget
        assert sp["resident_ops"] + sp["spilled_ops"] == len(t_idx.ops)
        assert _spill_stats(t_idx) == _spill_stats(r_idx)
        assert t_idx.prov_nbytes() == r_idx.prov_nbytes()
        assert sum(isinstance(op.tensor, _TensorFault) for op in t_idx.ops) == sp["spilled_ops"]
        spilled = next(op for op in t_idx.ops if isinstance(op.tensor, _TensorFault))
        assert spilled.info.kept_rows is None and spilled.tensor.device == t_idx.device
        assert _segments(t_idx._spill.store.root) == _segments(r_idx._spill.store.root)

    @pytest.mark.parametrize("budget", [512, 1024, 4096])
    def test_fault_back_answers_and_counters_match_reference(self, budget):
        r_ref, t_ref, sink = _filter_chains(n=256, hops=8)
        r_idx, t_idx, _ = _filter_chains(n=256, hops=8, spill=SpillPolicy(budget_bytes=budget),
                                         r_spill=RPolicy(budget_bytes=budget))
        assert t_idx.stats()["spill"]["spilled_ops"] > 0
        rng = np.random.default_rng(budget)
        probes = [sorted(set(rng.integers(0, 256, 6).tolist())) for _ in range(4)]
        from repro.provenance import prov as rprov
        from repro_torch.provenance import prov

        for (a, b, d) in (("d0", sink, "fwd"), (sink, "d0", "bwd")):
            if d == "bwd":
                n = t_idx.datasets[sink].n_rows
                probes = [sorted(set(rng.integers(0, n, 4).tolist())) for _ in range(4)]
            q = prov(t_idx).source(a).rows_batch(probes)
            rq = rprov(r_idx).source(a).rows_batch(probes)
            q, rq = (q.forward(), rq.forward()) if d == "fwd" else (q.backward(), rq.backward())
            got, want = q.to(b).run(), rq.to(b).run()
            ref = (prov(t_ref).source(a).rows_batch(probes).forward() if d == "fwd" else
                   prov(t_ref).source(a).rows_batch(probes).backward()).to(b).run()
            for g, w, u in zip(got, want, ref):
                np.testing.assert_array_equal(g.numpy(), w)
                assert torch.equal(g, u)
            assert _spill_stats(t_idx) == _spill_stats(r_idx)
        want = RComposed(r_ref, use_pallas=False).relation("d0", sink)
        got = ComposedIndex(t_idx).relation("d0", sink)
        r_got = RComposed(r_idx, use_pallas=False).relation("d0", sink)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(r_got, want)
        assert t_idx.stats()["spill"]["rehydrations"] > 0
        assert _spill_stats(t_idx) == _spill_stats(r_idx)

    def test_recompute_faults_spilled_tensor(self):
        r_ref, t_ref, _ = _filter_chains(n=128, hops=6, seed=3)
        r_idx, t_idx, _ = _filter_chains(n=128, hops=6, seed=3,
                                         spill=SpillPolicy(budget_bytes=512),
                                         r_spill=RPolicy(budget_bytes=512))
        for mid in ("d3", "d5"):
            rows = np.arange(t_idx.datasets[mid].n_rows, dtype=np.int64)[::-1].copy()
            got = recompute_rows(t_idx, mid, rows)
            want = r_recompute(r_idx, mid, rows)
            np.testing.assert_array_equal(got.data.numpy(), want.data)
            np.testing.assert_array_equal(got.null.numpy(), want.null)
            np.testing.assert_array_equal(got.index.numpy(), want.index)
            assert torch.equal(got.data, recompute_rows(t_ref, mid, rows).data)
        assert _spill_stats(t_idx) == _spill_stats(r_idx)

    def test_lru_mru_discipline(self):
        r_idx, t_idx, _ = _filter_chains(n=512, hops=10, spill=SpillPolicy(budget_bytes=2048),
                                         r_spill=RPolicy(budget_bytes=2048))
        t0 = t_idx.ops[0].tensor.resident()
        r_idx.ops[0].tensor.resident()
        assert type(t0) is ProvTensor and t_idx.ops[0].tensor is t0
        assert t_idx.stats()["spill"]["resident_bytes"] <= 2048
        assert 0 in t_idx._spill._resident
        assert list(t_idx._spill._resident) == list(r_idx._spill._resident)
        assert _spill_stats(t_idx) == _spill_stats(r_idx)

    def test_immutable_respill_skips_write(self):
        r_idx, t_idx, _ = _filter_chains(n=512, hops=10, spill=SpillPolicy(budget_bytes=2048),
                                         r_spill=RPolicy(budget_bytes=2048))
        st = t_idx._spill.policy.store
        for op in t_idx.ops:
            op.tensor.resident()
        writes_before = st.stats()["writes"]
        for _ in range(2):
            for op in t_idx.ops:
                op.tensor.resident()
        assert st.stats()["writes"] == writes_before and st.stats()["reads"] > 0
        for _ in range(3):
            for op in r_idx.ops:
                op.tensor.resident()
        assert _spill_stats(t_idx) == _spill_stats(r_idx)

    def test_resolve_spill_forms(self, tmp_path):
        assert resolve_spill(None) is None and resolve_spill(False) is None
        assert isinstance(resolve_spill(True), SpillPolicy)
        assert resolve_spill(str(tmp_path / "s")).path is not None
        pol = SpillPolicy(budget_bytes=123)
        assert resolve_spill(pol) is pol
        st = SpillStore(str(tmp_path / "log2"))
        assert resolve_spill(st).store is st
        with pytest.raises(TypeError):
            resolve_spill(3.14)

    def test_dropped_tensor_raises(self, tmp_path):
        """An op-tensor store must not drop segments: a fault of a dropped
        tensor raises instead of answering without it."""
        pol = SpillPolicy(budget_bytes=256, segment_bytes=512, disk_budget_bytes=512)
        _, t_idx, _ = _filter_chains(n=256, hops=6, spill=pol)
        assert pol.store.stats()["drops"] > 0
        dropped = next(op for op in t_idx.ops if isinstance(op.tensor, _TensorFault)
                       and op.op_id not in [k[2] for k in pol.store.keys()])
        with pytest.raises(RuntimeError, match="dropped"):
            dropped.tensor.resident()


# ===========================================================================
# Hop-cache: spill-backed eviction
# ===========================================================================
class TestHopcacheSpill:
    def test_append_storm_budget_respected(self):
        budget = 8192
        r_idx, t_idx, cur = _filter_chains(n=256, hops=4, seed=5)
        t_ci = ComposedIndex(t_idx, memory_budget_bytes=budget, spill=True)
        r_ci = RComposed(r_idx, memory_budget_bytes=budget, spill=True, use_pallas=False)
        rng = np.random.default_rng(99)
        for i in range(30):
            cur = _append_filter(r_idx, t_idx, cur, f"s{i}", rng, keep=0.95)
            if i % 3 == 0:
                np.testing.assert_array_equal(t_ci.relation("d0", cur).numpy(),
                                              r_ci.relation("d0", cur))
        st = t_ci.stats()
        assert st["bytes"] <= budget
        assert st["evictions"] > 0 and st["spills"] > 0
        assert {k: st[k] for k in HOP_KEYS} == {k: r_ci.stats()[k] for k in HOP_KEYS}
        assert _segments(st["spill"]["root"]) == _segments(r_ci.stats()["spill"]["root"])

    @pytest.mark.parametrize("backend", ["csr", "bitplane", "auto"])
    def test_spilled_entry_roundtrip(self, backend):
        r_idx, t_idx, sink = _filter_chains(n=200, hops=6, seed=11)
        want = ComposedIndex(t_idx, backend=backend).relation("d0", sink)
        tiny = ComposedIndex(t_idx, backend=backend, memory_budget_bytes=256, spill=True)
        r_tiny = RComposed(r_idx, backend=backend, memory_budget_bytes=256, spill=True,
                           use_pallas=False)
        first = tiny.relation("d0", sink)
        r_tiny.relation("d0", sink)
        assert tiny.stats()["spills"] > 0
        got = tiny.relation("d0", sink)              # faults back (or rebuilt)
        r_got = r_tiny.relation("d0", sink)
        rows, cols = t_idx.datasets["d0"].n_rows, t_idx.datasets[sink].n_rows
        for rel in (first, got):
            if backend == "csr":
                assert rel.crow_indices().dtype == torch.int32
                assert torch.equal(rel.to_dense(), want.to_dense())
            else:
                assert torch.equal(rel, want)
        np.testing.assert_array_equal(_dense(got, tiny.relation_backend("d0", sink), rows, cols),
                                      _dense(r_got, r_tiny.relation_backend("d0", sink),
                                             rows, cols))
        assert {k: tiny.stats()[k] for k in HOP_KEYS} == \
            {k: r_tiny.stats()[k] for k in HOP_KEYS}
        t_sp, r_sp = tiny.stats()["spill"], r_tiny.stats()["spill"]
        assert {k: t_sp[k] for k in STORE_KEYS} == {k: r_sp[k] for k in STORE_KEYS}
        if backend != "csr":
            assert _segments(t_sp["root"]) == _segments(r_sp["root"])
        else:
            _same_entries(tiny._spill_store, r_tiny._spill_store, {d: d for d in t_idx.datasets})

    @pytest.mark.parametrize("backend", ["auto", "csr", "bitplane"])
    @pytest.mark.parametrize("seed", range(3))
    def test_pipegen_spilled_hopcache_matches_reference(self, seed, backend):
        """Every (source, reachable dataset) pair of a replayed pipeline,
        probed twice through a hop-cache that spills: relations, probes and
        counters equal to ``repro``'s, and the same bytes on disk."""
        import pipegen
        from test_torch_capture import build_merged
        from test_torch_hopcache import r_dense, t_dense
        from test_torch_query import id_map

        base, specs = pipegen.random_specs(seed)
        r_idx, _ = pipegen.build_merged(base, specs)
        t_idx, _ = build_merged(base, specs)
        ids = id_map(r_idx, t_idx)
        r_ci = RComposed(r_idx, memory_budget_bytes=500, backend=backend, spill=True,
                         use_pallas=False)
        t_ci = ComposedIndex(t_idx, memory_budget_bytes=500, backend=backend, spill=True)
        pairs = [(src, d) for src in r_idx.sources() for d in ids
                 if d in r_idx.datasets and r_idx.path_exists(src, d)]
        rng = np.random.default_rng(seed)
        for src, dst in pairs + pairs:
            got, got_b = t_dense(t_ci, ids[src], ids[dst])
            want, want_b = r_dense(r_ci, src, dst)
            assert got_b == want_b
            np.testing.assert_array_equal(got, want)
            bwd = rng.random((3, r_idx.datasets[dst].n_rows)) < 0.3
            np.testing.assert_array_equal(
                t_ci.probe_backward(torch.from_numpy(bwd), ids[dst], ids[src]).numpy(),
                r_ci.probe_backward(bwd, dst, src))
            assert {k: t_ci.stats()[k] for k in HOP_KEYS} == \
                {k: r_ci.stats()[k] for k in HOP_KEYS}
        assert t_ci.stats()["spills"] > 0 and t_ci.stats()["rehydrations"] > 0
        # dataset ids come from each package's own counter, so the stores
        # are compared entry by entry through the id map, not file by file,
        # and without their disk bytes: each record's header names its key
        t_sp, r_sp = t_ci.stats()["spill"], r_ci.stats()["spill"]
        keys = [k for k in STORE_KEYS if k != "disk_bytes"]
        assert {k: t_sp[k] for k in keys} == {k: r_sp[k] for k in keys}
        _same_entries(t_ci._spill_store, r_ci._spill_store, ids)

    def test_residency_states(self):
        r_idx, t_idx, sink = _filter_chains(n=200, hops=5, seed=13)
        for backend in ("auto", "bitplane"):
            ci = ComposedIndex(t_idx, memory_budget_bytes=1 << 20, spill=True, backend=backend)
            assert ci.residency("d0", sink) is None
            ci.relation("d0", sink)
            assert ci.residency("d0", sink) == "ram"
            ci.memory_budget_bytes = 128
            ci._evict_over_budget()
            spilled = [f"d{k}" for k in range(1, 6) if ci.residency("d0", f"d{k}") == "spilled"]
            assert spilled and ci.contains("d0", spilled[0])
            stale = ci.stale_entries(["d1"])
            assert {s for s, _, r in stale if r == "spilled"} == {"d0"}
            ci.relation("d0", spilled[0])            # faults back, over budget: parked
            assert ci.stats()["rehydrations"] == 1 and ci.residency("d0", spilled[0]) == "spilled"
            ci.memory_budget_bytes = 1 << 20
            ci.relation("d0", spilled[0])            # faults back into the LRU
            assert ci.stats()["rehydrations"] == 2 and ci.residency("d0", spilled[0]) == "ram"
            dropped = ci.invalidate_datasets(["d1"])
            assert dropped and ci.stats()["spilled_entries"] == 0
            assert all(ci.residency(s, d) is None for s, d, _ in dropped)
            assert ci.stats()["spill"]["entries"] == 0

    def test_eager_extend_faults_spilled_tensors(self):
        """An appended structured op extends a warm relation eagerly, faulting
        its spilled tensor back; answers and counters equal repro's."""
        r_idx, t_idx, cur = _filter_chains(n=256, hops=4, seed=21,
                                           spill=SpillPolicy(budget_bytes=300),
                                           r_spill=RPolicy(budget_bytes=300))
        t_ci, r_ci = ComposedIndex(t_idx), RComposed(r_idx, use_pallas=False)
        t_ci.relation("d0", cur)
        r_ci.relation("d0", cur)
        base = t_ci.stats()["extends"]
        rng = np.random.default_rng(5)
        for i in range(3):
            cur = _append_filter(r_idx, t_idx, cur, f"e{i}", rng)
        assert isinstance(t_idx.ops[-2].tensor, _TensorFault)
        got = t_ci.relation("d0", cur)
        np.testing.assert_array_equal(got.numpy(), r_ci.relation("d0", cur))
        assert t_ci.stats()["extends"] >= base + 3
        assert {k: t_ci.stats()[k] for k in HOP_KEYS} == {k: r_ci.stats()[k] for k in HOP_KEYS}
        assert _spill_stats(t_idx) == _spill_stats(r_idx)
        assert torch.equal(got, ComposedIndex(t_idx).relation("d0", cur))

    def test_no_spill_keeps_plain_eviction(self):
        _, t_idx, sink = _filter_chains(n=200, hops=6, seed=17)
        ci = ComposedIndex(t_idx, memory_budget_bytes=512)
        ci.relation("d0", sink)
        st = ci.stats()
        assert st["spills"] == 0 and st["rehydrations"] == 0 and st["spilled_entries"] == 0
        assert "spill" not in st
