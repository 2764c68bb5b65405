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
from repro_torch.kernels.batched_walk import SMEM_BYTES, pick_block_b


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


@pytest.mark.parametrize("w_max,bb", [(1, 8), (1448, 8), (3632, 8), (3633, 4),
                                      (14528, 2), (29056, 1)])
def test_probe_block_fits_shared_memory(w_max, bb):
    assert pick_block_b(w_max) == bb
    assert 2 * bb * w_max * 4 <= SMEM_BYTES


def test_frontier_too_wide_for_shared_memory_raises():
    with pytest.raises(ValueError, match="too wide"):
        pick_block_b(SMEM_BYTES // 8 + 1)


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
