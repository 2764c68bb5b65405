"""The port's kernel entry points on the CPU against the JAX package.

``repro_torch.kernels.ops.batched_walk`` on CPU tensors takes the plain
PyTorch version; it must give the same words and counts as ``repro``'s jnp
oracle, as ``repro``'s Pallas kernel run in interpret mode, and as
``repro``'s numpy twin of the contraction (``bitplane_or_reduce``) folded
over the chain, which needs no compilation per shape and so carries the
property test.  Inputs are made with numpy from a seed and handed to both.
Words are compared exactly, as uint32 (``.numpy().view(np.uint32)``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro.core import provtensor as RP
from repro.kernels import ops as RK
from repro.kernels import ref as RR
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.kernels.batched_walk import (MIN_CAP, SMEM_BYTES, SMS, pick_block_b,
                                              walk_geometry, walk_smem_bytes)
from repro_torch.kernels.bitmatmul import (SLICE_WORDS, bitmatmul_geometry,
                                           bitmatmul_smem_bytes)


def _to_port(words) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pack_np(dense: np.ndarray) -> np.ndarray:
    return RP.pack_bitplane(dense)


def _random_chain(rng, n0, hops, density):
    """Packed numpy planes for a K-hop chain with non-multiple-of-32 dims."""
    dims = [n0] + [int(rng.integers(5, 90)) for _ in range(hops)]
    planes = [_pack_np(rng.random((dims[j], dims[j + 1])) < density) for j in range(hops)]
    return dims, planes


def _walk_numpy(mask_np, planes_np):
    """``repro``'s host (OR, AND) contraction folded over the chain."""
    cur, counts = mask_np, []
    for plane in planes_np:
        cur = RP.bitplane_or_reduce(cur, plane, plane.shape[0])
        counts.append([RP.bitplane_popcount(row) for row in cur])
    return cur, np.asarray(counts, dtype=np.int32).reshape(len(planes_np), -1)


def _walk_both(mask_np, planes_np):
    got = TK.batched_walk(_to_port(mask_np), [_to_port(p) for p in planes_np])
    return got, _walk_numpy(mask_np, planes_np)


# ---------------------------------------------------------------------------
# bit packing, popcount, bitmatmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cols", [1, 31, 32, 33, 64, 100])
def test_pack_unpack_match_reference(cols):
    rng = np.random.default_rng(cols)
    dense = rng.random((7, cols)) < 0.5
    dense[:, -1] = True                          # bit 31 of the last word when cols % 32 == 0
    words = TR.pack_bits(torch.from_numpy(dense))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(_u32(words), _pack_np(dense))
    np.testing.assert_array_equal(TR.unpack_bits(words, cols).numpy(), dense)
    np.testing.assert_array_equal(
        TR.unpack_bits(words, cols).numpy(),
        np.asarray(RR.unpack_bits(jnp.asarray(_u32(words)), cols)))


def test_popcount_swar_counts_every_bit():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=500, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    want = np.array([int(w).bit_count() for w in words])
    np.testing.assert_array_equal(TR.popcount32(_to_port(words)).numpy(), want)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (5, 33, 70), (9, 64, 31)])
def test_bitmatmul_ref_matches_reference(m, k, n):
    rng = np.random.default_rng(m * 100 + k + n)
    a = _pack_np(rng.random((m, k)) < 0.3)
    b = _pack_np(rng.random((k, n)) < 0.3)
    got = TR.bitmatmul_ref(_to_port(a), _to_port(b))
    want = np.asarray(RR.bitmatmul_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_u32(got), want)


# ---------------------------------------------------------------------------
# batched_walk: the fused K-hop record probe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hops,density", [(1, 0.25), (3, 0.02), (5, 0.25)])
def test_batched_walk_matches_reference_oracle(hops, density):
    rng = np.random.default_rng(hops * 100 + int(density * 100))
    n0 = int(rng.integers(5, 90))
    _, planes = _random_chain(rng, n0, hops, density)
    mask = _pack_np(rng.random((7, n0)) < 0.3)
    got_out, got_cnt = TK.batched_walk(_to_port(mask), [_to_port(p) for p in planes])
    want_out, want_cnt = RR.batched_walk_ref(jnp.asarray(mask), [jnp.asarray(p) for p in planes])
    assert got_cnt.dtype == torch.int32 and tuple(got_cnt.shape) == (hops, 7)
    np.testing.assert_array_equal(_u32(got_out), np.asarray(want_out))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))


@pytest.mark.parametrize("hops", [1, 3, 5])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.25])
def test_batched_walk_matches_host_contraction(hops, density):
    rng = np.random.default_rng(hops * 1000 + int(density * 100))
    n0 = int(rng.integers(5, 90))
    _, planes = _random_chain(rng, n0, hops, density)
    mask = _pack_np(rng.random((9, n0)) < 0.3)
    (got_out, got_cnt), (want_out, want_cnt) = _walk_both(mask, planes)
    np.testing.assert_array_equal(_u32(got_out), want_out)
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)


@pytest.mark.parametrize("hops,seed", [(1, 0), (3, 1), (5, 2)])
def test_batched_walk_matches_interpret_mode_pallas(hops, seed):
    """The JAX package's Pallas kernel, run as its own tests run it."""
    rng = np.random.default_rng(seed)
    n0 = int(rng.integers(5, 90))
    _, planes = _random_chain(rng, n0, hops, 0.1)
    mask = _pack_np(rng.random((6, n0)) < 0.3)
    got_out, got_cnt = TK.batched_walk(_to_port(mask), [_to_port(p) for p in planes])
    want_out, want_cnt = RK.batched_walk(jnp.asarray(mask), [jnp.asarray(p) for p in planes],
                                         use_pallas=True, interpret=True,
                                         block_b=4, block_k=64)
    np.testing.assert_array_equal(_u32(got_out), np.asarray(want_out))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))


def test_batched_walk_empty_masks():
    rng = np.random.default_rng(3)
    _, planes = _random_chain(rng, 40, 3, 0.1)
    out, cnt = TK.batched_walk(torch.zeros((5, 2), dtype=torch.int32),
                               [_to_port(p) for p in planes])
    assert not out.any() and not cnt.any()
    out, cnt = TK.batched_walk(torch.zeros((0, 2), dtype=torch.int32),
                               [_to_port(p) for p in planes])
    assert tuple(out.shape) == (0, planes[-1].shape[1]) and tuple(cnt.shape) == (3, 0)


def test_batched_walk_ignores_mask_bits_past_the_plane_rows():
    """A frontier word packs up to 32 rows; bits past n_j select nothing."""
    rng = np.random.default_rng(4)
    _, planes = _random_chain(rng, 40, 2, 0.3)
    mask = _pack_np(rng.random((3, 40)) < 0.5)
    dirty = mask.copy()
    dirty[:, -1] |= np.uint32(0xFF000000)        # rows 56..63 do not exist
    (a, ca), _ = _walk_both(mask, planes)
    (b, cb), (want, want_cnt) = _walk_both(dirty, planes)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(_u32(b), want)
    np.testing.assert_array_equal(cb.numpy(), want_cnt)


def test_batched_walk_chain_mismatch_raises():
    rng = np.random.default_rng(0)
    a = _to_port(_pack_np(rng.random((4, 40)) < 0.2))
    bad = _to_port(_pack_np(rng.random((90, 10)) < 0.2))   # 90 rows != 40
    with pytest.raises(ValueError):
        TK.batched_walk(a, [bad])
    with pytest.raises(ValueError):
        TK.batched_walk(a, [])


def test_batched_walk_has_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU goes to a kernel or raises."""
    mask = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    plane = torch.zeros((20, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TK.batched_walk(mask, [plane])


def test_batched_walk_counts_dispatches():
    rng = np.random.default_rng(21)
    _, planes = _random_chain(rng, 50, 5, 0.1)
    mask = _to_port(_pack_np(rng.random((8, 50)) < 0.2))
    TK.reset_launch_counts()
    TK.batched_walk(mask, [_to_port(p) for p in planes])
    assert TK.launch_counts() == {"batched_walk": 1}
    TK.reset_launch_counts()


@pytest.mark.parametrize("b,w_max,bb", [(64, 226, 1), (1100, 226, 8), (301, 226, 2),
                                        (601, 1018, 4), (1100, 14000, 2), (5000, 28900, 1)])
def test_probe_block_fits_shared_memory(b, w_max, bb):
    """The largest probe block that still gives every SM a CTA and fits,
    with the smallest row list, in one block's shared memory."""
    assert pick_block_b(w_max, b) == bb
    assert walk_smem_bytes(bb, w_max, MIN_CAP) <= SMEM_BYTES
    assert -(-b // bb) >= SMS or bb == 1


def test_frontier_too_wide_for_shared_memory_raises():
    with pytest.raises(ValueError, match="too wide"):
        pick_block_b(SMEM_BYTES // 8 + 1, 64)
    with pytest.raises(ValueError, match="too wide"):
        walk_geometry(64, 29000)          # fits two frontiers, not a row list beside them


@pytest.mark.parametrize("b", [1, 64, 257, 1100, 5000])
@pytest.mark.parametrize("w_max", [1, 32, 100, 226, 1018, 14000, 28900])
def test_walk_geometry_fits_shared_memory(b, w_max):
    geo = walk_geometry(b, w_max)
    assert geo.smem_bytes == walk_smem_bytes(geo.block_b, w_max, geo.cap) <= SMEM_BYTES
    assert geo.block_b == pick_block_b(w_max, b)
    # the largest power-of-two list that fits, at least one thread's entries
    assert MIN_CAP <= geo.cap <= 4096 and geo.cap & (geo.cap - 1) == 0
    assert geo.cap == 4096 or walk_smem_bytes(geo.block_b, w_max, 2 * geo.cap) > SMEM_BYTES
    # thread slices: each slice still has a thread per word of the frontier
    assert geo.slices in (1, 2, 4, 8)
    assert geo.slices == 1 or 256 // geo.slices >= 32 * -(-w_max // 32)


@pytest.mark.parametrize("m,nw,want", [
    (64, 216, (8, 7, 32)),            # the Compas probe: 2-D grid, slices of a warp
    (0, 0, (1, 1, 32)),
    (800, 216, (100, 4, 64)),
    (1100, 216, (138, 2, 128)),
    (7214, 216, (902, 1, 256)),       # the Compas composition: whole rows
    (2113, 375, (265, 1, 512)),
    (32561, 1018, (4071, 1, 1024)),   # the Census composition: whole rows, A read once
    (5000, 3000, (625, 3, 1024)),
])
def test_bitmatmul_geometry(m, nw, want):
    geo = bitmatmul_geometry(m, nw)
    assert tuple(geo) == want
    assert geo.slice_words in SLICE_WORDS
    assert bitmatmul_smem_bytes(geo.slice_words) <= SMEM_BYTES


@given(st.integers(0, 40000), st.integers(0, 5000))
@settings(max_examples=50, deadline=None)
def test_bitmatmul_geometry_property(m, nw):
    geo = bitmatmul_geometry(m, nw)
    assert geo.row_tiles * 8 >= m and geo.word_slices * geo.slice_words >= nw
    assert nw == 0 or (geo.word_slices - 1) * geo.slice_words < nw
    # fills the card, or has slices of one warp, or keeps whole rows (A read once)
    whole = geo.slice_words >= min(max(nw, 256), 1024)
    assert geo.row_tiles * geo.word_slices >= 2 * SMS or geo.slice_words == 32 or whole
    assert bitmatmul_smem_bytes(geo.slice_words) <= SMEM_BYTES


def test_bitmatmul_geometry_too_wide_raises():
    with pytest.raises(ValueError, match="at most"):
        bitmatmul_geometry(10**6, 70_000_000)


@given(st.integers(1, 5), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_batched_walk_property(hops, seed):
    rng = np.random.default_rng(seed)
    n0 = int(rng.integers(1, 70))
    _, planes = _random_chain(rng, n0, hops, float(rng.choice([0.0, 0.05, 0.5])))
    mask = _pack_np(rng.random((int(rng.integers(1, 9)), n0)) < 0.3)
    (got_out, got_cnt), (want_out, want_cnt) = _walk_both(mask, planes)
    np.testing.assert_array_equal(_u32(got_out), want_out)
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)


# ---------------------------------------------------------------------------
# bitmatmul / bitplane_probe: the hop-cache's contraction
# ---------------------------------------------------------------------------
def _bits_past_k(a: np.ndarray, k: int) -> np.ndarray:
    """A copy of packed A with every bit past column k of the last word set."""
    dirty = a.copy()
    if k % 32:
        dirty[:, -1] |= np.uint32((0xFFFFFFFF << (k % 32)) & 0xFFFFFFFF)
    return dirty


@pytest.mark.parametrize("m,k,n,density", [(1, 1, 1, 0.5), (5, 33, 70, 0.3), (9, 64, 31, 0.1),
                                           (16, 100, 40, 0.0), (3, 31, 129, 0.5)])
def test_bitmatmul_matches_interpret_mode_pallas_and_dense(m, k, n, density):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    dense_a = rng.random((m, k)) < density
    dense_b = rng.random((k, n)) < density
    a, b = _pack_np(dense_a), _pack_np(dense_b)
    got = TK.bitmatmul(_to_port(a), _to_port(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, (n + 31) // 32)
    want = np.asarray(RK.bitmatmul(jnp.asarray(a), jnp.asarray(b), block_m=8, block_nw=8,
                                   block_k=32, interpret=True, use_pallas=True))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got), _pack_np((dense_a.astype(int) @ dense_b) > 0))
    # bits of A past K select nothing
    dirty = TK.bitmatmul(_to_port(_bits_past_k(a, k)), _to_port(b))
    np.testing.assert_array_equal(dirty.numpy(), got.numpy())


def test_bitplane_probe_is_bitmatmul_and_counts_one_launch():
    rng = np.random.default_rng(8)
    a = _pack_np(rng.random((7, 45)) < 0.2)
    b = _pack_np(rng.random((45, 90)) < 0.2)
    TK.reset_launch_counts()
    got = TK.bitplane_probe(_to_port(a), _to_port(b))
    assert TK.launch_counts() == {"bitmatmul": 1}
    np.testing.assert_array_equal(_u32(got), RP.bitplane_or_reduce(a, b, 45))
    TK.reset_launch_counts()


def test_bitmatmul_contraction_mismatch_raises():
    with pytest.raises(ValueError, match="contraction"):
        TK.bitmatmul(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((20, 3), dtype=torch.int32))


@given(st.integers(1, 12), st.integers(1, 100), st.integers(1, 100), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_bitmatmul_property(m, k, n, seed):
    rng = np.random.default_rng(seed)
    density = float(rng.choice([0.0, 0.05, 0.5]))
    a = _pack_np(rng.random((m, k)) < density)
    b = _pack_np(rng.random((k, n)) < density)
    got = TK.bitmatmul(_to_port(_bits_past_k(a, k)), _to_port(b))
    np.testing.assert_array_equal(_u32(got), RP.bitplane_or_reduce(a, b, k))


# ---------------------------------------------------------------------------
# bitset_rank: inclusive rank over one packed bitset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 100, 1000])
def test_bitset_rank_matches_oracle_and_host_twin(n_bits):
    from repro.core.schema import Bitset

    rng = np.random.default_rng(n_bits)
    b = Bitset.from_bits(rng.random(n_bits) < 0.4)
    pos = np.concatenate([np.arange(n_bits), [-1, -7]]).astype(np.int32)
    got = TK.bitset_rank(_to_port(b.words), torch.from_numpy(pos))
    assert got.dtype == torch.int32
    want_jnp = np.asarray(RR.bitset_rank_ref(jnp.asarray(b.words), jnp.asarray(pos)))
    np.testing.assert_array_equal(got.numpy(), want_jnp)
    np.testing.assert_array_equal(got.numpy(), [b.rank(int(p)) for p in pos])


def test_bitset_rank_past_the_last_bit_is_the_total():
    words = _to_port(np.array([0xFFFFFFFF, 0x80000001], dtype=np.uint32))
    got = TK.bitset_rank(words, torch.tensor([63, 64, 1000, -1], dtype=torch.int32))
    assert got.tolist() == [34, 34, 34, 0]
    assert TK.bitset_rank(torch.zeros(0, dtype=torch.int32),
                          torch.tensor([0, -1], dtype=torch.int32)).tolist() == [0, 0]


@given(st.lists(st.booleans(), min_size=1, max_size=200), st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_bitset_rank_property(bits, seed):
    from repro.core.schema import Bitset

    b = Bitset.from_bits(bits)
    pos = np.random.default_rng(seed).integers(-1, len(bits), 17).astype(np.int32)
    got = TK.bitset_rank(_to_port(b.words), torch.from_numpy(pos)).numpy()
    cum = np.concatenate([[0], np.cumsum(np.asarray(bits, int))])
    np.testing.assert_array_equal(got, np.where(pos >= 0, cum[np.clip(pos, -1, len(bits) - 1) + 1], 0))


# ---------------------------------------------------------------------------
# lineage_gather: padded CSR neighbour table
# ---------------------------------------------------------------------------
def _random_csr(rng, n_rows, n_cols, nnz):
    rows = np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    row_ptr = np.zeros(n_rows + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=row_ptr[1:])
    return row_ptr, cols


@pytest.mark.parametrize("n_rows,n_cols,nnz,max_deg", [(100, 50, 300, 16), (33, 7, 90, 33),
                                                        (5, 5, 0, 1), (12, 40, 60, 200)])
def test_lineage_gather_matches_oracle(n_rows, n_cols, nnz, max_deg):
    rng = np.random.default_rng(nnz + max_deg)
    row_ptr, cols = _random_csr(rng, n_rows, n_cols, nnz)
    queries = rng.integers(0, n_rows, 37).astype(np.int32)
    got = TK.lineage_gather(torch.from_numpy(row_ptr), torch.from_numpy(cols),
                            torch.from_numpy(queries), max_deg=max_deg)
    assert got.dtype == torch.int32 and tuple(got.shape) == (37, max_deg)
    colp = jnp.concatenate([jnp.asarray(cols), jnp.full((max_deg,), -1, jnp.int32)])
    want = RR.lineage_gather_ref(jnp.asarray(queries), jnp.asarray(row_ptr), colp,
                                 max_deg=max_deg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lineage_gather_matches_host_csr():
    from repro.core.provtensor import CSR

    rng = np.random.default_rng(5)
    csr = CSR.from_pairs(rng.integers(0, 20, 60), rng.integers(0, 30, 60), 20, 30)
    qs = np.arange(20, dtype=np.int32)
    md = int(np.diff(csr.row_ptr).max())
    got = TK.lineage_gather(torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_idx),
                            torch.from_numpy(qs), max_deg=md)
    np.testing.assert_array_equal(got.numpy(), csr.batch_neighbors(qs, max_deg=md))


# ---------------------------------------------------------------------------
# the per-hop baseline: K x 3 launches, byte-equal to the fused walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hops,density", [(1, 0.25), (3, 0.02), (7, 0.1)])
def test_unfused_walk_equals_fused_in_k_times_3_launches(hops, density):
    rng = np.random.default_rng(hops)
    n0 = int(rng.integers(5, 90))
    _, planes = _random_chain(rng, n0, hops, density)
    mask = _to_port(_pack_np(rng.random((9, n0)) < 0.3))
    tplanes = [_to_port(p) for p in planes]
    TK.reset_launch_counts()
    out, cnt = TK.batched_walk_unfused(mask, tplanes)
    assert TK.launch_counts() == {"bitmatmul": hops, "bitset_rank": hops,
                                  "lineage_gather": hops}
    TK.reset_launch_counts()
    want_out, want_cnt = TK.batched_walk(mask, tplanes)
    assert TK.launch_counts() == {"batched_walk": 1}
    assert torch.equal(out, want_out) and torch.equal(cnt, want_cnt)
    r_out, r_cnt = RK.batched_walk_unfused(_u32(mask), planes, use_pallas=False)
    np.testing.assert_array_equal(_u32(out), np.asarray(r_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(r_cnt))
    TK.reset_launch_counts()


@pytest.mark.parametrize("entry,args", [
    ("bitmatmul", lambda d: (torch.zeros((2, 1), dtype=torch.int32, device=d),
                             torch.zeros((20, 1), dtype=torch.int32, device=d))),
    ("bitset_rank", lambda d: (torch.zeros(3, dtype=torch.int32, device=d),
                               torch.zeros(2, dtype=torch.int32, device=d))),
    ("lineage_gather", lambda d: (torch.zeros(3, dtype=torch.int32, device=d),
                                  torch.zeros(4, dtype=torch.int32, device=d),
                                  torch.zeros(2, dtype=torch.int32, device=d))),
    ("batched_walk_unfused", lambda d: (torch.zeros((2, 1), dtype=torch.int32, device=d),
                                        [torch.zeros((20, 1), dtype=torch.int32, device=d)])),
    ("join_gather", lambda d: (torch.zeros((3, 4), dtype=torch.float32, device=d),
                               torch.zeros((3, 4), dtype=torch.bool, device=d),
                               torch.zeros((5, 2), dtype=torch.float32, device=d),
                               torch.zeros((5, 2), dtype=torch.bool, device=d),
                               torch.zeros((6, 2), dtype=torch.int32, device=d), 0, 0)),
    ("join_match", lambda d: (torch.zeros(3, dtype=torch.float32, device=d),
                              torch.zeros(5, dtype=torch.float32, device=d),
                              torch.zeros(5, dtype=torch.int64, device=d))),
])
def test_new_entries_have_no_fallback_off_the_cpu(entry, args):
    kw = {"max_deg": 2} if entry == "lineage_gather" else {}
    with pytest.raises(ValueError, match="no kernel"):
        getattr(TK, entry)(*args("meta"), **kw)
