"""The join's row pairs (``kernels.ops.join_match``) on the CPU.

``ops.join`` builds its row pairs with ``join_match`` from a stable sort of
the right keys; its plain version and ``ops.join`` are held to ``repro``'s
join: the same pairs bit for bit (and the same table, bitsets and
permutation lists) for inner, left, right and outer joins over unique
right keys (TPC-DI's shape), duplicates on both sides, one key matched by
5,000 right rows, no match, an empty side, NaN keys (of either sign) on
either side, ``-0.0`` against ``0.0``, unsorted left keys and
``max_pairs``.  Keys compare in numpy's order: every NaN last and equal,
``-0.0`` equal to ``0.0`` (``torch.searchsorted`` on the floats orders NaN
otherwise).

A numpy model of the CUDA kernel's index arithmetic (``csrc/join_match.cu``:
the power-of-two splitter stride, the branch-free search over the
splitters, the guess between two splitters' values and the galloping
search from it, the galloping run end, the tile scan with a
warp's decoupled look-back whose tiles publish in any order, the warp's 32-way
search for a write block's rows, the staged or unstaged per-pair search
and the output-balanced write) is held to the plain version at the
kernel's geometry and at a small one whose strides, tiles and write blocks
are many at these sizes.  Each join counts one ``join_match`` dispatch,
and the operand checks raise on what the kernel does not take.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.dataprep import ops as RO
from repro.dataprep.table import Table as RTable
from repro_torch.dataprep import ops as TO
from repro_torch.dataprep.table import Table
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref
from repro_torch.kernels.join_match import (ITEMS, MAX_SPLITTERS, OUT_ITEMS, OUT_TILE, THREADS,
                                            TILE_ROWS, check_match_total, match_geometry)

CPU = "cpu"
HOWS = ["inner", "left", "right", "outer"]
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def _keys(name, rng):
    """(left keys, right keys, max_pairs) of a case, float32."""
    n, m = 41, 29
    max_pairs = None
    if name == "unique_right":                      # TPC-DI: many left rows to one right row
        rk = rng.permutation(m).astype(np.float32)
        lk = rng.integers(0, m + 6, n).astype(np.float32)   # a few dangle
    elif name == "duplicates":
        lk = rng.integers(0, 8, n).astype(np.float32)
        rk = rng.integers(4, 12, m).astype(np.float32)
    elif name == "skew":
        rk = np.concatenate([np.full(5000, 7.0), rng.integers(0, 20, m)]).astype(np.float32)
        rk = rk[rng.permutation(len(rk))]
        lk = rng.integers(0, 20, n).astype(np.float32)
        lk[[3, 17]] = 7.0
    elif name == "no_match":
        lk = rng.integers(0, 10, n).astype(np.float32)
        rk = rng.integers(100, 110, m).astype(np.float32)
    elif name == "nan_keys":
        lk = rng.integers(0, 6, n).astype(np.float32)
        rk = rng.integers(0, 6, m).astype(np.float32)
        lk[[1, 8, 30]] = np.nan
        rk[[0, 5, 6, 20]] = np.nan
    elif name == "nan_left_only":
        lk = rng.integers(0, 6, n).astype(np.float32)
        rk = rng.integers(0, 6, m).astype(np.float32)
        lk[[2, 9]] = np.nan
    elif name == "signed_nan":                       # NaN with its sign bit set, either side
        lk = rng.integers(0, 6, n).astype(np.float32)
        rk = rng.integers(0, 6, m).astype(np.float32)
        neg = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
        lk[[1, 8]], rk[[0, 6]] = (neg, np.nan), (np.nan, neg)
    elif name == "nan_right_only":
        lk = rng.integers(0, 6, n).astype(np.float32)
        rk = rng.integers(0, 6, m).astype(np.float32)
        rk[[1, 2, 28]] = np.nan
    elif name == "negative_zero":
        lk = rng.integers(-2, 3, n).astype(np.float32)
        rk = rng.integers(-2, 3, m).astype(np.float32)
        lk[lk == 0] = np.where(rng.random(int((lk == 0).sum())) < 0.5, -0.0, 0.0)
        rk[rk == 0] = np.where(rng.random(int((rk == 0).sum())) < 0.5, -0.0, 0.0)
        lk[0], rk[0], rk[1] = -0.0, 0.0, -0.0
    elif name == "descending_left":
        lk = np.sort(rng.integers(0, 15, n))[::-1].astype(np.float32)
        rk = rng.integers(0, 15, m).astype(np.float32)
    elif name == "max_pairs":
        lk = rng.integers(0, 8, n).astype(np.float32)
        rk = rng.integers(4, 12, m).astype(np.float32)
        max_pairs = 23
    else:
        raise KeyError(name)
    return np.ascontiguousarray(lk), np.ascontiguousarray(rk), max_pairs


CASES = ["unique_right", "duplicates", "skew", "no_match", "nan_keys", "nan_left_only",
         "nan_right_only", "signed_nan", "negative_zero", "descending_left", "max_pairs"]


def _tables(lk, rk, rng):
    left = {"x": rng.normal(size=len(lk)).astype(np.float32), "k": lk,
            "y": rng.normal(size=len(lk)).astype(np.float32)}
    right = {"k": rk, "z": rng.normal(size=len(rk)).astype(np.float32)}
    return ((RTable.from_columns(left), Table.from_columns(left, device=CPU)),
            (RTable.from_columns(right), Table.from_columns(right, device=CPU)))


def _same_join(r_res, t_res):
    (rt, ri), (tt, ti) = r_res, t_res
    assert ti.join_pairs.dtype == torch.int32 and ti.join_pairs.is_contiguous()
    np.testing.assert_array_equal(ti.join_pairs.numpy(), ri.join_pairs)
    assert tt.columns == rt.columns
    np.testing.assert_array_equal(_bits(tt.data.numpy()), _bits(rt.data))
    np.testing.assert_array_equal(tt.null.numpy(), rt.null)
    assert (ti.op_name, ti.n_out, list(ti.n_in)) == (ri.op_name, int(ri.n_out), list(ri.n_in))
    for ra, ta in zip(ri.attr_maps, ti.attr_maps):
        np.testing.assert_array_equal(ta.bitset.words.numpy().view(np.uint32), ra.bitset.words)
        np.testing.assert_array_equal(ta.perm.numpy(), ra.perm)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("how", HOWS)
def test_join_matches_reference_pairs(how, case):
    rng = np.random.default_rng(len(case) * 7 + len(how))
    lk, rk, max_pairs = _keys(case, rng)
    (r_l, t_l), (r_r, t_r) = _tables(lk, rk, rng)
    _same_join(RO.join(r_l, r_r, "k", how, max_pairs=max_pairs),
               TO.join(t_l, t_r, "k", how, max_pairs=max_pairs))


@pytest.mark.parametrize("sizes,how", [((0, 7), "inner"), ((0, 7), "left"), ((9, 0), "inner"),
                                       ((9, 0), "right"), ((0, 0), "outer")])
def test_join_with_an_empty_side_matches_reference(sizes, how):
    """The joins ``repro`` can run with an empty side (its assembly indexes
    an empty table for the others)."""
    rng = np.random.default_rng(sum(sizes))
    lk = rng.integers(0, 4, sizes[0]).astype(np.float32)
    rk = rng.integers(0, 4, sizes[1]).astype(np.float32)
    (r_l, t_l), (r_r, t_r) = _tables(lk, rk, rng)
    _same_join(RO.join(r_l, r_r, "k", how), TO.join(t_l, t_r, "k", how))


def _numpy_match(lk, rk):
    """repro's match: a stable argsort and numpy's two searchsorteds."""
    order = np.argsort(rk, kind="stable")
    srt = rk[order]
    lo = np.searchsorted(srt, lk, side="left")
    counts = np.searchsorted(srt, lk, side="right") - lo
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64) if len(lk) else lo
    l_rows = np.repeat(np.arange(len(lk)), counts)
    flat = np.repeat(lo - offsets, counts) + np.arange(counts.sum())
    return counts, offsets, np.stack([l_rows, order[flat]], axis=1)


def _plain(lk, rk):
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    return TK.join_match(torch.from_numpy(lk), srt.values, srt.indices)


SPECIAL = np.array([3.0, np.nan, 1.0, -0.0, 3.0, np.nan, 0.0, -np.inf, np.inf, -1e-45, 1e-45,
                    -5.0, np.float32(-np.nan), 2.5], dtype=np.float32)


@pytest.mark.parametrize("case", CASES + ["special_values"])
def test_plain_version_matches_numpy_order(case):
    rng = np.random.default_rng(3)
    if case == "special_values":                     # NaN of either sign, infinities, denormals
        lk = np.concatenate([SPECIAL, SPECIAL[::-1]]).astype(np.float32)
        rk = SPECIAL[rng.permutation(len(SPECIAL))]
    else:
        lk, rk, _ = _keys(case, rng)
    counts, offsets, pairs = _plain(lk, rk)
    want_counts, want_offsets, want_pairs = _numpy_match(lk, rk)
    assert counts.dtype == offsets.dtype == pairs.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(pairs.numpy(), want_pairs.reshape(-1, 2))


def test_torch_searchsorted_alone_breaks_numpy_order():
    """The fault the order key repairs: on the floats, a NaN left key
    finds no NaN right key, and a 3.0 counts the NaN rows as matches."""
    rk = torch.tensor([3.0, np.nan, 1.0, -0.0, 3.0, np.nan])
    srt = torch.sort(rk, stable=True).values
    lk = torch.tensor([np.nan, 3.0])
    lo, hi = torch.searchsorted(srt, lk), torch.searchsorted(srt, lk, right=True)
    assert (hi - lo).tolist() != [2, 2]
    counts, _, _ = TK.join_match(lk, srt, torch.sort(rk, stable=True).indices)
    assert counts.tolist() == [2, 2]


def test_order_key_sorts_as_numpy():
    keys = ref.order_key(torch.from_numpy(SPECIAL)).numpy()
    assert keys.min() >= 0 and keys.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"),
                                  np.argsort(SPECIAL, kind="stable"))
    nan, zero = np.isnan(SPECIAL), SPECIAL == 0
    assert len(set(keys[nan])) == 1 and len(set(keys[zero])) == 1


# -- the kernel's index arithmetic, modelled in numpy ---------------------------------
def _km(n, less):
    """The kernel's branch-free lower bound over n >= 1 places: the same
    halving for every key, then one last comparison."""
    base = 0
    while n > 1:
        half = n >> 1
        if less(base + half):
            base += half
        n -= half
    return base + (1 if less(base) else 0)


def _key_value(k):
    """``key_value``: the float32 whose order key is k."""
    k = int(k)
    bits = k & 0x7FFFFFFF if k & 0x80000000 else ~k & 0xFFFFFFFF
    return np.array([bits], np.uint32).view(np.float32)[0]


def _gallop_lower(at, u, a, b, g):
    """``gallop_lower``: the first place in [a, b] at or past u, from the
    guess g, given that place b's key is."""
    d = 1
    if at(g) < u:
        while g + d < b and at(g + d) < u:
            d <<= 1
        lo, hi = g + (d >> 1) + 1, min(g + d, b)
    else:
        while g - d >= a and at(g - d) >= u:
            d <<= 1
        lo, hi = max(g - d + 1, a), g - (d >> 1)
    m = hi - lo
    while m > 0:
        half = m >> 1
        if at(lo + half) < u:
            lo, m = lo + half + 1, m - half - 1
        else:
            m = half
    return lo


def _warp_upper_bound(arr, a, b, v):
    """``warp_upper_bound``: 32 probes a step, their count of ``<= v`` a
    prefix of the lanes."""
    while b - a > 32:
        step = (b - a + 31) >> 5
        hits = [a + lane * step < b and arr[a + lane * step] <= v for lane in range(32)]
        c = sum(hits)
        assert hits == [True] * c + [False] * (32 - c)
        if c == 0:
            return a
        a, b = a + (c - 1) * step + 1, min(a + c * step, b)
    return a + sum(a + lane < b and arr[a + lane] <= v for lane in range(32))


def kernel_model(lk, rk_sorted, order, *, threads=THREADS, items=ITEMS,
                 max_split=MAX_SPLITTERS, out_items=OUT_ITEMS, seed=0):
    """What the two launches of ``join_match.cu`` write, key by key, tile by
    tile and pair by pair; asserts every load lies inside its array and
    every pair is written once, and bounds the loads of a key's search.
    Returns (counts, offsets, pairs) and the write paths that ran and the
    loads of each key's search."""
    nl, nr = len(lk), len(rk_sorted)
    tile = threads * items
    tiles = -(-nl // tile)
    stride = 1 << (max(1, -(-nr // max_split)) - 1).bit_length()
    n_split = -(-nr // stride)
    assert stride & (stride - 1) == 0 and n_split <= max_split
    u_all = ref.order_key(torch.from_numpy(lk)).numpy()
    r = ref.order_key(torch.from_numpy(rk_sorted)).numpy()
    split = np.append(r[::stride], r[-1:])             # and the last key, at nr - 1
    assert len(split) == (n_split + 1 if nr else 0)
    loads = []

    def at(i):
        assert 0 <= i < nr
        loads[-1] += 1
        return r[i]

    counts = np.zeros(nl, np.int64)
    lo_all = np.zeros(nl, np.int64)
    for row in range(nl):                             # launch 1: the search
        x, u = np.float32(lk[row]), u_all[row]
        s = _km(n_split + 1, lambda i: split[i] < u) if nr else 0
        lo = 0 if s == 0 else nr
        loads.append(0)
        if 0 < s <= n_split:
            p0 = (s - 1) * stride
            a, b = p0 + 1, (s * stride if s < n_split else nr - 1)
            v0, v1 = _key_value(split[s - 1]), _key_value(split[s])
            g = (a + b) >> 1
            if np.isfinite(x) and np.isfinite(v0) and np.isfinite(v1):
                with np.errstate(all="ignore"):
                    f = np.fmin(np.fmax((x - v0) / (v1 - v0), np.float32(0)), np.float32(1))
                g = max(p0 + int(f * np.float32(b - p0)), a)
            assert a <= g <= b and split[s] == r[b] >= u > r[a - 1]
            lo = _gallop_lower(at, u, a, b, g)
            assert loads[-1] <= 2 * max(b - a, 1).bit_length() + 2
        hi = lo
        if lo < nr and at(lo) == u:
            d = 1
            while lo + d < nr and at(lo + d) == u:
                d <<= 1
            c = lo + d // 2 + 1
            m = min(lo + d, nr) - c
            while m > 0:
                half = m >> 1
                if at(c + half) == u:
                    c, m = c + half + 1, m - half - 1
                else:
                    m = half
            hi = c
        counts[row], lo_all[row] = hi - lo, lo

    # the scan: tile sums, then a warp's look-back, 32 tiles a step, in an
    # order the tiles may publish in
    sums = [int(counts[t * tile:(t + 1) * tile].sum()) for t in range(tiles)]
    status = [None] + [("A", sums[t]) for t in range(1, tiles)]
    prefix = [None] * tiles
    pending = list(np.random.default_rng(seed).permutation(tiles))
    while pending:
        t = pending.pop(0)
        p, j0 = 0, t - 32
        while t > 0:
            window = [status[j] if j >= 0 else ("P", 0) for j in range(j0, j0 + 32)]
            if None in window:                        # spins until all 32 have published
                break
            prefixes = [lane for lane, w in enumerate(window) if w[0] == "P"]
            p += sum(w[1] for w in window[max(prefixes, default=0):])
            if prefixes:
                break
            j0 -= 32
        if t > 0 and None in window:
            pending.append(t)
            continue
        status[t], prefix[t] = ("P", p + sums[t]), p
    offsets = np.zeros(nl, np.int64)
    for t in range(tiles):
        c = counts[t * tile:(t + 1) * tile]
        offsets[t * tile:(t + 1) * tile] = prefix[t] + np.cumsum(c) - c
    total = status[-1][1] if tiles else 0
    assert total == counts.sum()
    start = lo_all - offsets

    # launch 2: CTAs of out_tile consecutive pairs
    out_tile = threads * out_items
    pairs = np.full((total, 2), -7, np.int64)
    written = np.zeros(total, np.int64)
    paths = set()
    for blk in range(-(-total // out_tile)):
        p0, p_last = blk * out_tile, min((blk + 1) * out_tile, total) - 1
        first = _warp_upper_bound(offsets, 0, nl, p0) - 1
        last = _warp_upper_bound(offsets, first, nl, p_last) - 1
        assert first == np.searchsorted(offsets, p0, side="right") - 1
        assert last == np.searchsorted(offsets, p_last, side="right") - 1
        rows = last - first + 1
        paths.add("staged" if rows <= out_tile else "global")
        off = offsets[first:first + rows]
        for k in range(out_items):
            for tid in range(threads):
                p = p0 + k * threads + tid
                pc = min(p, p_last)
                base, n = 0, rows
                while n > 1:
                    half = n >> 1
                    if off[base + half] <= pc:
                        base += half
                    n -= half
                if p <= p_last:
                    assert off[base] <= p < off[base] + counts[first + base]
                    j = start[first + base] + p
                    assert 0 <= j < nr
                    pairs[p] = (first + base, order[j])
                    written[p] += 1
    assert (written == 1).all()
    return counts, offsets, pairs, {"paths": paths, "loads": np.array(loads)}


SMALL = {"threads": 4, "items": 4, "max_split": 8, "out_items": 2}


def _model_keys(rng, nl, nr):
    dom = max(1, nr // 3)
    lk = rng.integers(0, dom + 2, nl).astype(np.float32)
    rk = rng.integers(0, dom, nr).astype(np.float32)
    if nl > 3:
        lk[[0, nl // 2]] = np.nan, -0.0
    if nr > 3:
        rk[[1, nr // 3]] = np.nan, 0.0
    return lk, rk


@pytest.mark.parametrize("geometry", ["kernel", "small"])
@pytest.mark.parametrize("nr", [0, 1, 31, 33, 1000])
@pytest.mark.parametrize("nl", [0, 1, 31, 33, 1000])
def test_kernel_model_matches_plain_version(nl, nr, geometry):
    rng = np.random.default_rng(nl * 1009 + nr)
    lk, rk = _model_keys(rng, nl, nr)
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    kw = SMALL if geometry == "small" else {}
    counts, offsets, pairs, _ = kernel_model(lk, srt.values.numpy(), srt.indices.numpy(),
                                             seed=nl + nr, **kw)
    want = TK.join_match(torch.from_numpy(lk), srt.values, srt.indices)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(offsets, want[1].numpy())
    np.testing.assert_array_equal(pairs, want[2].numpy().reshape(-1, 2))


@pytest.mark.parametrize("case", ["skew", "no_match", "nan_keys", "negative_zero",
                                  "descending_left"])
def test_kernel_model_on_the_join_cases(case):
    lk, rk, _ = _keys(case, np.random.default_rng(11))
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    counts, offsets, pairs, _ = kernel_model(lk, srt.values.numpy(), srt.indices.numpy(),
                                             **SMALL)
    np.testing.assert_array_equal(pairs, _numpy_match(lk, rk)[2].reshape(-1, 2))


def test_kernel_model_takes_both_write_paths():
    """Rows of a write block staged in shared memory when they fit, the
    offsets read in place when zero-count rows between matches do not."""
    rng = np.random.default_rng(5)
    lk = np.full(1000, -1.0, np.float32)
    lk[::97] = rng.integers(0, 5, len(lk[::97]))
    lk[500] = 2.0
    rk = np.concatenate([rng.integers(0, 5, 40), np.full(300, 2.0)]).astype(np.float32)
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    counts, offsets, pairs, info = kernel_model(lk, srt.values.numpy(), srt.indices.numpy(),
                                                **SMALL)
    assert info["paths"] == {"staged", "global"}
    np.testing.assert_array_equal(pairs, _numpy_match(lk, rk)[2].reshape(-1, 2))


# -- geometry, constants, checks and dispatches ---------------------------------------
def _constexprs() -> dict:
    src = (CSRC / "join_match.cu").read_text()
    return dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))


def test_launcher_constants_match_the_source():
    c = _constexprs()
    assert int(c["kThreads"]) == THREADS and int(c["kItems"]) == ITEMS
    assert int(c["kMaxSplit"]) == MAX_SPLITTERS and int(c["kOutItems"]) == OUT_ITEMS
    assert TILE_ROWS == THREADS * ITEMS and OUT_TILE == THREADS * OUT_ITEMS
    assert ITEMS == 4                                  # one int4 store of each output a thread


@pytest.mark.parametrize("nr", [0, 1, 2, 4095, 4096, 4097, 8193, 2_601_648, (1 << 31) - 1])
def test_splitters_fit_shared_memory_a_power_of_two_apart(nr):
    geo = match_geometry(2_411_006, nr)
    assert geo.stride & (geo.stride - 1) == 0 and geo.splitters <= MAX_SPLITTERS
    assert geo.splitters == -(-nr // geo.stride)
    assert geo.stride == 1 or -(-nr // (geo.stride // 2)) > MAX_SPLITTERS
    assert geo.tiles == -(-2_411_006 // TILE_ROWS) and geo.scratch_words == geo.tiles + 2
    if nr == 2_601_648:
        assert (geo.stride, geo.splitters) == (1024, 2541)


def _operands():
    rng = np.random.default_rng(2)
    lk, rk = _model_keys(rng, 20, 17)
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    return [torch.from_numpy(lk), srt.values, srt.indices]


BAD = {
    "float64 left keys": lambda a: a.__setitem__(0, a[0].double()),
    "int32 order": lambda a: a.__setitem__(2, a[2].to(torch.int32)),
    "float16 right keys": lambda a: a.__setitem__(1, a[1].half()),
    "strided left keys": lambda a: a.__setitem__(0, torch.stack([a[0], a[0]], 1)[:, 0]),
    "strided order": lambda a: a.__setitem__(2, torch.stack([a[2], a[2]], 1)[:, 1]),
    "2-D left keys": lambda a: a.__setitem__(0, a[0].reshape(4, 5)),
    "order shorter than the keys": lambda a: a.__setitem__(2, a[2][:-1]),
    "keys shorter than the order": lambda a: a.__setitem__(1, a[1][1:]),
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_operand_checks_raise(what):
    args = _operands()
    TK.join_match(*args)
    BAD[what](args)
    with pytest.raises(ValueError, match="join_match"):
        TK.join_match(*args)


def test_total_past_int32_raises():
    check_match_total((1 << 31) - 1 - OUT_TILE)
    with pytest.raises(ValueError, match="fewer than 2"):
        check_match_total((1 << 31) - OUT_TILE)


@pytest.mark.parametrize("how", HOWS)
def test_one_match_a_join(how):
    rng = np.random.default_rng(9)
    lk, rk, _ = _keys("duplicates", rng)
    (_, t_l), (_, t_r) = _tables(lk, rk, rng)
    TK.reset_launch_counts()
    TO.join(t_l, t_r, "k", how)
    assert TK.launch_counts() == {"join_match": 1, "join_gather": 1}
    TO.join(t_l, t_r, "k", how, max_pairs=2)
    assert TK.launch_counts() == {"join_match": 2, "join_gather": 2}
    TK.reset_launch_counts()


@pytest.mark.parametrize("spread", ["dense", "gapped", "exponential"])
def test_kernel_model_guess_is_cheap_on_smooth_keys(spread):
    """Unique keys spread evenly (TPC-DI's securities) cost a load or two
    a key below the splitters, where halving 1,024 places costs 11; keys
    crowded at one end of each bucket cost more, within the model's bound
    of 2 log2(stride) + 2."""
    rng = np.random.default_rng(4)
    n = 8192
    rk = {"dense": np.arange(n), "gapped": np.arange(n) * 3 + 1000,
          "exponential": np.exp(np.linspace(0, 12, n))}[spread].astype(np.float32)
    lk = rk[rng.integers(0, n, 600)]
    rk = rk[rng.permutation(n)]
    srt = torch.sort(torch.from_numpy(rk), stable=True)
    counts, _, pairs, info = kernel_model(lk, srt.values.numpy(), srt.indices.numpy(),
                                          max_split=8)                 # stride 1024
    assert (counts == 1).all()
    np.testing.assert_array_equal(pairs, _numpy_match(lk, rk)[2].reshape(-1, 2))
    mean = info["loads"].mean()
    assert mean <= 4.0 if spread != "exponential" else mean <= 2 * 11 + 2 + 2
