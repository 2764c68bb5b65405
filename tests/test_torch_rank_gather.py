"""The redesigned ``bitset_rank`` and ``lineage_gather`` kernels, on the CPU.

The CUDA kernels cannot run here, so this file checks what surrounds them
and the arithmetic they do:

* the launchers' pure-Python geometry (grids, tile count, workspace),
  against hand-worked values, and its constants against the ``.cu``
  sources;
* a numpy model of the tiled rank decomposition the kernel computes (tile
  totals -> exclusive prefix -> line prefix within the tile -> popcount of
  the line's words before the position's word -> the word masked to the
  position), at the kernel's real tile and line sizes, held to ``repro``'s
  jnp oracle and to ``repro.core.schema.Bitset.rank`` at the tile edges;
* a numpy model of the gather kernel's assignment of output words to warps
  and lanes, with its multiply-high division by ``max_deg``, held to the
  oracles below, and that division checked exactly against ``//``;
* the port's entry points ``ops.bitset_rank`` and ``ops.lineage_gather`` on
  CPU tensors (their plain versions) against the same oracles and
  ``repro.core.provtensor.CSR.batch_neighbors``, at those edges and on a
  degree-1 CSR shaped like the TPC-DI join's out -> in relation;
* that the CUDA launchers raise for tensors on the CPU instead of running
  the plain version.

Every comparison is exact (tolerance 0).  ``repro``'s Pallas kernels do
not run in interpret mode under this container's jax, so its oracles here
are jnp and numpy.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import provtensor as RP
from repro.core.schema import Bitset
from repro.kernels import ref as RR
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.kernels.bitset_rank import (LINE_WORDS, MAX_TILES, THREADS, TILE_WORDS,
                                             RankGeometry, bitset_rank_cuda, rank_geometry)
from repro_torch.kernels.lineage_gather import (THREADS as GATHER_THREADS, WORDS_PER_THREAD,
                                                GatherGeometry, gather_geometry,
                                                lineage_gather_cuda, reciprocal)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _to_port(words) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32).copy())


def _constexprs(name: str) -> dict:
    src = (CSRC / name).read_text()
    return {k: v for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}


# ---------------------------------------------------------------------------
# launcher geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,q,want", [
    (0, 0, (0, 0, 0, 0, 0)),
    (5, 0, (0, 0, 0, 0, 0)),
    (0, 5, (0, 0, 1, 0, 1)),                       # W = 0: launch 2 alone writes zeros
    (1, 1, (1, 1, 1, 2, 2)),
    (8191, 64, (1, 256, 1, 257, 2)),               # one tile - 1 word
    (8192, 256, (1, 256, 1, 257, 2)),              # one tile; 256 queries, one CTA
    (8193, 257, (2, 257, 2, 259, 2)),              # one tile + 1; 257 queries, two CTAs
    (13824, 64, (2, 432, 1, 434, 2)),              # Compas Q2 first hop: 64 x 216 words
    (65152, 64, (8, 2036, 1, 2044, 2)),            # Census: 64 x 1018 words
    (4822016, 64, (589, 150688, 1, 151277, 2)),    # TPC-DI SF20: 64 x 75,344 words
    ((1 << 26) - 1, 1, (MAX_TILES, 1 << 21, 1, MAX_TILES + (1 << 21), 2)),
])
def test_rank_geometry_hand_worked(w, q, want):
    assert rank_geometry(w, q) == RankGeometry(*want)


@pytest.mark.parametrize("w,q", [(1 << 26, 1), (-1, 3), (4, -1)])
def test_rank_geometry_refuses(w, q):
    with pytest.raises(ValueError):
        rank_geometry(w, q)


@pytest.mark.parametrize("q,max_deg,want", [
    (0, 3, (0, 0, 0, 1431655766, 2)),
    (1, 1, (1, 1, 1, 1, 0)),
    (64, 8, (512, 1, 4, 1, 3)),                    # Compas Q2 first hop
    (257, 33, (8481, 9, 67, 4034666248, 6)),       # ragged last warp and CTA
    (2411006, 1, (2411006, 2355, 18836, 1, 0)),    # the SF20 join's out -> in CSR, in order
])
def test_gather_geometry_hand_worked(q, max_deg, want):
    assert gather_geometry(q, max_deg) == GatherGeometry(*want)


@pytest.mark.parametrize("q,max_deg", [(4, 0), (-1, 1), (1 << 20, 1 << 11)])
def test_gather_geometry_refuses(q, max_deg):
    with pytest.raises(ValueError):
        gather_geometry(q, max_deg)


def test_launcher_constants_match_the_sources():
    rank = _constexprs("bitset_rank.cu")
    assert int(rank["kThreads"]) == THREADS
    assert int(rank["kLineWords"]) == LINE_WORDS
    assert int(rank["kMaxTiles"]) == MAX_TILES
    assert THREADS * int(rank["kVec"]) * 4 == TILE_WORDS      # kTileWords
    assert TILE_WORDS // LINE_WORDS == THREADS                # one line a thread
    assert MAX_TILES * TILE_WORDS == 1 << 26                  # every W with 32 W < 2^31
    gather = _constexprs("lineage_gather.cu")
    assert int(gather["kThreads"]) == GATHER_THREADS and int(gather["kPer"]) == WORDS_PER_THREAD


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 33, 130, 1024, 4097, (1 << 20) + 1,
                               (1 << 30) + 1, (1 << 31) - 1])
def test_gather_reciprocal_divides_exactly(d):
    """The kernel's q = (mulhi(magic, e) + e) >> shift is e // max_deg for
    every output word index it can see, without overflowing 32 bits."""
    magic, shift = reciprocal(d)
    assert 0 < magic < 1 << 32 and 0 <= shift <= 31
    rng = np.random.default_rng(d)
    e = np.concatenate([[0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 3 * d - 1, (1 << 31) - 1,
                         (1 << 31) - 1025], rng.integers(0, 1 << 31, 4000)]).astype(np.uint64)
    e = e[e < 1 << 31]
    t = (np.uint64(magic) * e) >> np.uint64(32)
    assert np.all(t + e < np.uint64(1 << 32))
    np.testing.assert_array_equal((t + e) >> np.uint64(shift), e // np.uint64(d))


# ---------------------------------------------------------------------------
# the tiled rank decomposition, modelled in numpy at the kernel's constants
# ---------------------------------------------------------------------------
def _popc(words: np.ndarray) -> np.ndarray:
    return np.bitwise_count(np.asarray(words, dtype=np.uint32)).astype(np.int64)


def tiled_rank(words: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """What the two launches compute, step for step."""
    w_count = len(words)
    out = np.zeros(len(positions), dtype=np.int64)
    if w_count == 0:
        return out
    pops = _popc(words)
    tiles = -(-w_count // TILE_WORDS)
    padded = np.zeros(tiles * TILE_WORDS, dtype=np.int64)
    padded[:w_count] = pops
    line_counts = padded.reshape(tiles, TILE_WORDS // LINE_WORDS, LINE_WORDS).sum(axis=2)
    # launch 1: per-tile line prefixes (exclusive) and tile totals
    line_prefix = (np.cumsum(line_counts, axis=1) - line_counts).reshape(-1)
    tile_total = line_counts.sum(axis=1)
    # launch 2: exclusive prefix of the tile totals, then one line per query
    tile_prefix = np.cumsum(tile_total) - tile_total
    for i, p in enumerate(positions):
        if p < 0:
            continue
        p = min(int(p), 32 * w_count - 1)
        w = p >> 5
        line = w // LINE_WORDS
        first = line * LINE_WORDS
        partial = int(pops[first:w].sum())
        partial += int(_popc(np.uint32(words[w]) & np.uint32(0xFFFFFFFF >> (31 - (p & 31)))))
        out[i] = tile_prefix[line // (TILE_WORDS // LINE_WORDS)] + line_prefix[line] + partial
    return out


def _edge_positions(w_count: int) -> np.ndarray:
    """Positions at tile and line starts and ends, the ends of the set,
    and past them."""
    n = 32 * w_count
    pts = [-5, -1, 0, 1, 31, 32, n - 1, n, n + 77]
    for t in range(0, -(-w_count // TILE_WORDS) + 1):
        for d in (-33, -32, -1, 0, 1, 32):
            pts.append(32 * t * TILE_WORDS + d)
    for line in (1, 2, 255, 256, 257):
        pts += [32 * LINE_WORDS * line - 1, 32 * LINE_WORDS * line]
    return np.asarray(sorted({p for p in pts if p < n + 100}), dtype=np.int32)


EDGE_W = [1, 7, TILE_WORDS - 1, TILE_WORDS, TILE_WORDS + 1, 3 * TILE_WORDS - 1,
          3 * TILE_WORDS + 1]


def _words(w_count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=w_count, dtype=np.uint64).astype(np.uint32)
    words[rng.random(w_count) < 0.2] = 0xFFFFFFFF   # full words: bit 31 set
    return words


def _oracles(words: np.ndarray, pos: np.ndarray):
    """Bitset.rank for every position; repro's jnp oracle inside [-1, 32 W)
    (it does not clamp positions past the last bit)."""
    b = Bitset(n=32 * len(words), words=words)
    by_bitset = np.asarray([b.rank(int(p)) for p in pos], dtype=np.int64)
    inside = pos < 32 * len(words)
    by_jnp = np.asarray(RR.bitset_rank_ref(jnp.asarray(words), jnp.asarray(pos[inside])))
    return by_bitset, inside, by_jnp


@pytest.mark.parametrize("w_count", EDGE_W)
def test_tiled_decomposition_matches_repro_at_tile_edges(w_count):
    words = _words(w_count, w_count)
    pos = _edge_positions(w_count)
    got = tiled_rank(words, pos)
    by_bitset, inside, by_jnp = _oracles(words, pos)
    np.testing.assert_array_equal(got, by_bitset)
    np.testing.assert_array_equal(got[inside], by_jnp)


@pytest.mark.parametrize("w_count", EDGE_W)
def test_port_rank_matches_repro_and_the_model_at_tile_edges(w_count):
    words = _words(w_count, 7 * w_count)
    pos = _edge_positions(w_count)
    TK.reset_launch_counts()
    got = TK.bitset_rank(_to_port(words), torch.from_numpy(pos))
    assert TK.launch_counts() == {"bitset_rank": 1}
    TK.reset_launch_counts()
    assert got.dtype == torch.int32
    by_bitset, inside, by_jnp = _oracles(words, pos)
    np.testing.assert_array_equal(got.numpy(), by_bitset)
    np.testing.assert_array_equal(got.numpy()[inside], by_jnp)
    np.testing.assert_array_equal(got.numpy(), tiled_rank(words, pos))


@pytest.mark.parametrize("case", ["all_in_one_tile", "more_queries_than_tiles", "empty_bitset"])
def test_rank_query_layouts(case):
    rng = np.random.default_rng(3)
    if case == "empty_bitset":
        words = np.zeros(0, dtype=np.uint32)
        pos = np.asarray([-1, 0, 5, 1 << 20], dtype=np.int32)
    elif case == "all_in_one_tile":
        words = _words(3 * TILE_WORDS + 5, 11)
        lo = 32 * TILE_WORDS
        pos = rng.integers(lo, lo + 32 * TILE_WORDS, 300).astype(np.int32)
    else:
        words = _words(2 * TILE_WORDS + 3, 12)
        pos = rng.integers(-2, 32 * len(words) + 40, 600).astype(np.int32)
        assert len(pos) > rank_geometry(len(words), len(pos)).tiles
    got = TK.bitset_rank(_to_port(words), torch.from_numpy(pos)).numpy()
    b = Bitset(n=32 * len(words), words=words) if len(words) else None
    want = [b.rank(int(p)) if b else 0 for p in pos]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiled_rank(words, pos), want)


@given(st.integers(0, 2 * TILE_WORDS + 40), st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_tiled_decomposition_property(w_count, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=w_count, dtype=np.uint64).astype(np.uint32)
    words[rng.random(w_count) < float(rng.choice([0.0, 0.5, 0.99]))] = 0
    pos = rng.integers(-3, 32 * w_count + 50, 23).astype(np.int32)
    got = tiled_rank(words, pos)
    np.testing.assert_array_equal(got, TK.bitset_rank(_to_port(words), torch.from_numpy(pos)).numpy())
    cum = np.concatenate([[0], np.cumsum(_popc(words))])
    p = np.clip(pos, 0, max(32 * w_count - 1, 0))
    full = cum[p >> 5] + _popc(words[np.minimum(p >> 5, max(w_count - 1, 0))]
                               & (np.uint32(0xFFFFFFFF) >> (31 - (p & 31)).astype(np.uint32))) \
        if w_count else np.zeros(len(pos), np.int64)
    np.testing.assert_array_equal(got, np.where(pos < 0, 0, full))


# ---------------------------------------------------------------------------
# lineage_gather at the element grid's edges
# ---------------------------------------------------------------------------
def _csr_with_degrees(rng, degs, n_cols=1000):
    row_ptr = np.zeros(len(degs) + 1, np.int32)
    np.cumsum(degs, out=row_ptr[1:])
    return row_ptr, rng.integers(0, n_cols, int(row_ptr[-1])).astype(np.int32)


def _gather_oracles(row_ptr, cols, queries, max_deg):
    """repro's jnp oracle (sentinel-padded col_idx, as its wrapper pads it)
    for queries inside [0, R), and a row of -1 outside."""
    n_rows = len(row_ptr) - 1
    inside = (queries >= 0) & (queries < n_rows)
    colp = jnp.concatenate([jnp.asarray(cols), jnp.full((max_deg,), -1, jnp.int32)])
    want = np.full((len(queries), max_deg), -1, np.int32)
    if inside.any():
        want[inside] = np.asarray(RR.lineage_gather_ref(
            jnp.asarray(queries[inside]), jnp.asarray(row_ptr), colp, max_deg=max_deg))
    return want


def warp_gather(queries, row_ptr, col_idx, max_deg):
    """What the kernel computes, lane by lane, at its real constants: warp
    w, lane l writes words w * 32 * kPer + l + 32 i; each word once."""
    geo = gather_geometry(len(queries), max_deg)
    threads = np.arange(geo.ctas * GATHER_THREADS)
    warp, lane = threads // 32, threads % 32
    e = (warp * 32 * WORDS_PER_THREAD + lane)[:, None] + 32 * np.arange(WORDS_PER_THREAD)
    e = e[e < geo.words].astype(np.int64)
    assert np.array_equal(np.sort(e), np.arange(geo.words))
    q = (((geo.magic * e) >> 32) + e) >> geo.shift
    j = e - q * max_deg
    r = queries[q].astype(np.int64)
    valid = (r >= 0) & (r < len(row_ptr) - 1)
    rs = np.where(valid, r, 0)
    start = np.where(valid, row_ptr[rs], 0)
    deg = np.where(valid, row_ptr[rs + 1] - start, 0)
    live = j < deg
    out = np.full(geo.words, -1, np.int32)
    out[e[live]] = col_idx[(start + j)[live]]
    return out.reshape(len(queries), max_deg)


@pytest.mark.parametrize("max_deg", [1, 2, 3, 4, 5, 8, 33, 130])
@pytest.mark.parametrize("q", [1, 7, 1031])
def test_port_gather_matches_repro_at_grid_edges(q, max_deg):
    rng = np.random.default_rng(q * 1000 + max_deg)
    n_rows = 97
    degs = rng.integers(0, 2 * max_deg + 2, n_rows)
    degs[::5] = 0                                        # degree-0 rows
    degs[1::7] = max_deg + 3                             # rows longer than max_deg
    row_ptr, cols = _csr_with_degrees(rng, degs)
    queries = rng.integers(-2, n_rows + 2, q).astype(np.int32)   # some outside [0, R)
    TK.reset_launch_counts()
    got = TK.lineage_gather(torch.from_numpy(row_ptr), torch.from_numpy(cols),
                            torch.from_numpy(queries), max_deg=max_deg)
    assert TK.launch_counts() == {"lineage_gather": 1}
    TK.reset_launch_counts()
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, max_deg)
    np.testing.assert_array_equal(got.numpy(), _gather_oracles(row_ptr, cols, queries, max_deg))
    np.testing.assert_array_equal(warp_gather(queries, row_ptr, cols, max_deg), got.numpy())
    inside = (queries >= 0) & (queries < n_rows)
    csr = RP.CSR(n_rows=n_rows, n_cols=1000, row_ptr=row_ptr, col_idx=cols)
    np.testing.assert_array_equal(got.numpy()[inside],
                                  csr.batch_neighbors(queries[inside], max_deg=max_deg))


def test_port_gather_degree_one_join_relation():
    """Every row, in order, of a degree-1 out -> in CSR like the TPC-DI
    join's ``bwd(0)`` (one left row for each output row), at 10^5 rows."""
    rng = np.random.default_rng(20)
    n_left = 120_000
    g = np.sort(rng.choice(n_left, 100_000, replace=False)).astype(np.int32)
    csr = RP._gather_bwd_csr(g, n_left)
    assert np.all(np.diff(csr.row_ptr) == 1)
    queries = np.arange(csr.n_rows, dtype=np.int32)
    got = TK.lineage_gather(torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_idx),
                            torch.from_numpy(queries), max_deg=1)
    np.testing.assert_array_equal(got.numpy(), csr.batch_neighbors(queries, max_deg=1))
    np.testing.assert_array_equal(got.numpy(),
                                  _gather_oracles(csr.row_ptr, csr.col_idx, queries, 1))
    np.testing.assert_array_equal(got.numpy()[:, 0], g)
    np.testing.assert_array_equal(warp_gather(queries, csr.row_ptr, csr.col_idx, 1), got.numpy())


@given(st.lists(st.integers(0, 12), min_size=1, max_size=60), st.integers(1, 10),
       st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_port_gather_property(degs, max_deg, seed):
    rng = np.random.default_rng(seed)
    row_ptr, cols = _csr_with_degrees(rng, np.asarray(degs))
    queries = rng.integers(0, len(degs), int(rng.integers(1, 50))).astype(np.int32)
    got = TK.lineage_gather(torch.from_numpy(row_ptr), torch.from_numpy(cols),
                            torch.from_numpy(queries), max_deg=max_deg)
    csr = RP.CSR(n_rows=len(degs), n_cols=1000, row_ptr=row_ptr, col_idx=cols)
    np.testing.assert_array_equal(got.numpy(), csr.batch_neighbors(queries, max_deg=max_deg))


# ---------------------------------------------------------------------------
# the launchers never take the plain version
# ---------------------------------------------------------------------------
def _refuse(*a, **k):
    raise AssertionError("a CUDA launcher called the plain version")


@pytest.mark.parametrize("w,q", [(0, 3), (1, 1), (TILE_WORDS + 1, 300)])
def test_rank_launcher_raises_off_the_card(monkeypatch, w, q):
    monkeypatch.setattr(TR, "bitset_rank_ref", _refuse)
    with pytest.raises(ValueError, match="CUDA card"):
        bitset_rank_cuda(torch.zeros(w, dtype=torch.int32), torch.zeros(q, dtype=torch.int32))


@pytest.mark.parametrize("max_deg", [1, 4, 33])
def test_gather_launcher_raises_off_the_card(monkeypatch, max_deg):
    monkeypatch.setattr(TR, "lineage_gather_ref", _refuse)
    with pytest.raises(ValueError, match="CUDA card"):
        lineage_gather_cuda(torch.zeros(5, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                            torch.zeros(3, dtype=torch.int32), max_deg)
