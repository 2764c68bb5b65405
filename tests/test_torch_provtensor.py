"""The port's representation layer against the JAX package's, exactly.

Random structured (identity, gather with -1 sentinels, append ranges, join
pairs) and explicit-COO tensors are built in both packages from the same
numpy arrays; every mirror — CSR halves, packed bitplanes, batched mask
probes, row probes, the payload round-trip, byte accounting — must agree.
The schema bitsets and attribute maps are held to ``repro``'s too.
"""
import numpy as np
import pytest
import torch

from repro.core import opcat as RO
from repro.core import provtensor as RP
from repro.core import schema as RS
from repro_torch.core import opcat as TO
from repro_torch.core import provtensor as TP
from repro_torch.core import schema as TS

CPU = "cpu"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pair(kind: str, rng):
    """(repro tensor, port tensor) of one kind, from one set of numpy arrays."""
    n_in = int(rng.integers(1, 60))
    if kind == "identity":
        return RP.identity_tensor(n_in), TP.identity_tensor(n_in, device=CPU)
    if kind == "hreduce":
        kept = np.flatnonzero(rng.random(n_in) < 0.6).astype(np.int32)
        return RP.hreduce_tensor(kept, n_in), TP.hreduce_tensor(_t(kept), n_in)
    if kind == "haugment":
        src = rng.integers(-1, n_in, size=int(rng.integers(1, 80))).astype(np.int32)
        return RP.haugment_tensor(src, n_in), TP.haugment_tensor(_t(src), n_in)
    if kind == "join":
        n_r = int(rng.integers(1, 40))
        pairs = np.stack([rng.integers(-1, n_in, 50), rng.integers(-1, n_r, 50)], 1).astype(np.int32)
        return RP.join_tensor(pairs, n_in, n_r), TP.join_tensor(_t(pairs), n_in, n_r)
    if kind == "append":
        n_r = int(rng.integers(1, 40))
        return RP.append_tensor(n_in, n_r), TP.append_tensor(n_in, n_r, device=CPU)
    if kind == "coo":
        n_out = int(rng.integers(1, 50))
        coo = np.stack([rng.integers(0, n_out, 90), rng.integers(-1, n_in, 90)], 1).astype(np.int32)
        return (RP.ProvTensor(n_out=n_out, n_in=(n_in,), coo=coo),
                TP.ProvTensor(n_out=n_out, n_in=(n_in,), coo=_t(coo)))
    raise ValueError(kind)


KINDS = ["identity", "hreduce", "haugment", "join", "append", "coo"]


def _assert_csr(r: RP.CSR, t: TP.CSR):
    assert (r.n_rows, r.n_cols) == (t.n_rows, t.n_cols)
    np.testing.assert_array_equal(t.row_ptr.numpy(), r.row_ptr)
    np.testing.assert_array_equal(t.col_idx.numpy(), r.col_idx)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(4))
def test_mirrors_match_reference(kind, seed):
    rng = np.random.default_rng(seed * 10 + KINDS.index(kind))
    r, t = _pair(kind, rng)
    assert t.device == torch.device("cpu")
    assert (r.n_out, r.n_in, r.nnz, r.structured) == (t.n_out, t.n_in, t.nnz, t.structured)
    np.testing.assert_array_equal(t.coo.numpy(), r.coo)
    for k in range(r.k):
        _assert_csr(r.fwd(k), t.fwd(k))
        _assert_csr(r.bwd(k), t.bwd(k))
        np.testing.assert_array_equal(_u32(t.bitplane_fwd(k)), r.bitplane_fwd(k))
        np.testing.assert_array_equal(_u32(t.bitplane_bwd(k)), r.bitplane_bwd(k))
        in_masks = rng.random((5, r.n_in[k])) < 0.3
        out_masks = rng.random((5, r.n_out)) < 0.3
        np.testing.assert_array_equal(t.forward_mask_batch(k, _t(in_masks)).numpy(),
                                      r.forward_mask_batch(k, in_masks))
        np.testing.assert_array_equal(t.backward_mask_batch(k, _t(out_masks)).numpy(),
                                      r.backward_mask_batch(k, out_masks))
        np.testing.assert_array_equal(t.forward_mask(k, _t(in_masks[0])).numpy(),
                                      r.forward_mask(k, in_masks[0]))
        np.testing.assert_array_equal(t.backward_mask(k, _t(out_masks[1])).numpy(),
                                      r.backward_mask(k, out_masks[1]))
        rows_in = rng.integers(0, r.n_in[k], size=4)
        rows_out = rng.integers(0, r.n_out, size=4)
        np.testing.assert_array_equal(t.forward_rows(k, rows_in.tolist()).numpy(),
                                      r.forward_rows(k, rows_in.tolist()))
        np.testing.assert_array_equal(t.backward_rows(k, rows_out).numpy(),
                                      r.backward_rows(k, rows_out))
        np.testing.assert_array_equal(t.fwd(k).gather_rows(rows_in).numpy(),
                                      r.fwd(k).gather_rows(rows_in))
        np.testing.assert_array_equal(t.bwd(k).batch_neighbors(rows_out).numpy(),
                                      r.bwd(k).batch_neighbors(rows_out))
        np.testing.assert_array_equal(t.bwd(k).neighbor_mask(rows_out).numpy(),
                                      r.bwd(k).neighbor_mask(rows_out))
    assert t.nbytes() == r.nbytes()
    assert t.nbytes(include_index=False) == r.nbytes(include_index=False)


@pytest.mark.parametrize("kind", KINDS)
def test_payload_round_trip_and_carry_from_reference(kind):
    rng = np.random.default_rng(100 + KINDS.index(kind))
    r, t = _pair(kind, rng)
    meta, arrays = t.to_payload()
    rmeta, rarrays = r.to_payload()
    assert meta == rmeta and sorted(arrays) == sorted(rarrays)
    for name in arrays:
        np.testing.assert_array_equal(arrays[name].numpy(), rarrays[name])
    for back in (TP.ProvTensor.from_payload(meta, arrays, device=CPU),
                 TP.ProvTensor.from_payload(rmeta, rarrays, device=CPU)):
        assert back.structured == r.structured
        np.testing.assert_array_equal(back.coo.numpy(), r.coo)
        for k in range(r.k):
            np.testing.assert_array_equal(_u32(back.bitplane_fwd(k)), r.bitplane_fwd(k))


def test_canonicalize_matches_reference():
    rng = np.random.default_rng(7)
    src = rng.integers(-1, 20, size=30).astype(np.int32)
    r, t = RP.haugment_tensor(src, 20), TP.haugment_tensor(_t(src), 20)
    groups = np.minimum(np.arange(30), rng.integers(0, 30, size=30)).astype(np.int32)
    rc, tc = r.canonicalize(groups), t.canonicalize(_t(groups))
    np.testing.assert_array_equal(tc.coo.numpy(), rc.coo)
    assert not tc.structured


def test_out_of_range_row_probe_raises():
    t = TP.hreduce_tensor(torch.tensor([0, 2], dtype=torch.int32), 3)
    with pytest.raises(IndexError):
        t.backward_rows(0, [5])


@pytest.mark.parametrize("cols", [0, 1, 31, 32, 33, 100])
def test_pack_helpers_match_reference(cols):
    rng = np.random.default_rng(cols)
    dense = rng.random((6, cols)) < 0.4
    np.testing.assert_array_equal(_u32(TP.pack_bitplane(_t(dense))), RP.pack_bitplane(dense))
    words = RP.pack_bitplane(dense)
    np.testing.assert_array_equal(TP.unpack_bitplane(_t(words.view(np.int32)), cols).numpy(),
                                  RP.unpack_bitplane(words, cols))
    rows, cc = np.nonzero(dense)
    np.testing.assert_array_equal(
        _u32(TP.pack_pairs(_t(rows), _t(cc), 6, cols, min_words=1)),
        RO._pack_pairs(rows, cc, 6, cols))
    assert TP.bitplane_popcount(_t(words.view(np.int32))) == RP.bitplane_popcount(words)
    if cols:
        sel = RP.pack_bitplane(rng.random((3, 6)) < 0.5)
        np.testing.assert_array_equal(
            _u32(TP.bitplane_or_reduce(_t(sel.view(np.int32)), _t(words.view(np.int32)), 6)),
            RP.bitplane_or_reduce(sel, words, 6))
        m = dense[0]
        np.testing.assert_array_equal(_u32(TP.pack_mask(_t(m))), RP.pack_mask(m))


# ---------------------------------------------------------------------------
# schema bitsets and attribute maps (host-side CPU tensors)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 5, 32, 33, 70])
def test_bitset_matches_reference(n):
    rng = np.random.default_rng(n)
    bits = rng.random(n) < 0.5
    r, t = RS.Bitset.from_bits(bits), TS.Bitset.from_bits(bits)
    np.testing.assert_array_equal(_u32(t.words), r.words)
    assert str(t) == str(r) and t.popcount() == r.popcount() and t.nbytes() == r.nbytes()
    np.testing.assert_array_equal(t.indices().numpy(), r.indices())
    np.testing.assert_array_equal(TS.rank_positions(t).numpy(), RS.rank_positions(r))
    for i in range(-1, n + 1):
        assert t.rank(i) == r.rank(i)
        assert t.select(i) == r.select(i)
    for i in range(n):
        assert t.test(i) == r.test(i)
    assert TS.Bitset.from_string("10011").indices().tolist() == [0, 3, 4]


@pytest.mark.parametrize("amap_kind", ["identity", "vreduce", "vreduce_perm", "vaugment",
                                       "join", "join_perm"])
def test_attr_map_planes_match_reference(amap_kind):
    n_in, n_out = 9, 13
    idx = [1, 4, 5, 7]
    if amap_kind == "identity":
        r, t = RO.AttrMap("identity"), TO.AttrMap("identity")
    elif amap_kind.startswith("vreduce"):
        r = RO.AttrMap("vreduce", bitset=RS.Bitset.from_indices(idx, n_in))
        t = TO.AttrMap("vreduce", bitset=TS.Bitset.from_indices(idx, n_in))
        n_out = len(idx)
        if amap_kind == "vreduce_perm":
            r.perm = np.array([5, 1, 7, 4], np.int32)
            t.perm = torch.tensor([5, 1, 7, 4], dtype=torch.int32)
    elif amap_kind == "vaugment":
        r = RO.AttrMap("vaugment", bitset=RS.Bitset.from_indices([2, 9, 10, 11], n_out), m=n_in)
        t = TO.AttrMap("vaugment", bitset=TS.Bitset.from_indices([2, 9, 10, 11], n_out), m=n_in)
    else:
        r = RO.AttrMap("join", bitset=RS.Bitset.from_indices([0, 2, 3, 6], n_out))
        t = TO.AttrMap("join", bitset=TS.Bitset.from_indices([0, 2, 3, 6], n_out))
        if amap_kind == "join_perm":
            perm = np.full(n_out, -1, np.int32)
            perm[[0, 2, 3, 6]] = [3, 0, 8, 1]
            r.perm, t.perm = perm, torch.from_numpy(perm.copy())
    for a, b in zip(t.pairs(n_in, n_out), r.pairs(n_in, n_out)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(_u32(t.fwd_plane(n_in, n_out, "cpu")), r.fwd_plane(n_in, n_out))
    np.testing.assert_array_equal(_u32(t.bwd_plane(n_in, n_out, "cpu")), r.bwd_plane(n_in, n_out))
    assert t.nbytes() == r.nbytes()
