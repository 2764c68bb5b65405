"""The join's output assembly (``kernels.ops.join_gather``) on the CPU.

``ops.join`` builds its output from the row pairs with ``join_gather``; its
plain version and ``ops.join`` are held to ``repro``'s join: the same pairs,
the same data bit for bit, the same null flags, column names, bitsets and
permutation lists, for inner, left, right and outer joins with dangles on
both sides, duplicate keys, a key that is not the first column, colliding
names, nulls, ``max_pairs`` and an empty result.  A numpy model of the CUDA
kernel's walk (``csrc/join_gather.cu``: a warp's 32 pairs, each lane's
(row, column) stepping by (32 // C, 32 % C) with a carry, the column map
from the keys and widths) is held to the plain version at widths around
the warp's 32 words and at ragged last warps.  Each join counts one
``join_gather`` dispatch (and one ``join_match``, which built its pairs),
and the operand checks raise on what the kernel does not take.
"""
import numpy as np
import pytest
import torch

from repro.dataprep import ops as RO
from repro.dataprep.table import Table as RTable
from repro_torch.dataprep import ops as TO
from repro_torch.dataprep.table import Table
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref

CPU = "cpu"
HOWS = ["inner", "left", "right", "outer"]


def _both(cols, nulls=None):
    return (RTable.from_columns(cols, null=nulls),
            Table.from_columns(cols, null=nulls, device=CPU))


def _case(name, seed=0):
    """(left, right) as (repro, port) table pairs, and ``max_pairs``."""
    rng = np.random.default_rng(seed)
    n, m = 37, 23

    def vals(k):
        return rng.normal(size=k).astype(np.float32)

    lkeys = rng.integers(0, 12, n).astype(np.float32)          # duplicates on both sides
    rkeys = rng.integers(6, 18, m).astype(np.float32)          # 0-5 and 12-17 dangle
    left = {"k": lkeys, "x": vals(n), "g": rng.integers(0, 4, n).astype(np.float32),
            "y": vals(n)}
    right = {"k": rkeys, "z": vals(m), "x": vals(m)}            # "x" collides: x_l, x_r
    lnull = rnull = None
    max_pairs = None
    if name == "key_not_first":
        left = {"x": left["x"], "g": left["g"], "k": lkeys, "y": left["y"]}
        right = {"z": right["z"], "x": right["x"], "k": rkeys}
    elif name == "nulls":
        lnull = {"x": rng.random(n) < 0.3, "k": rng.random(n) < 0.2, "y": rng.random(n) < 0.3}
        rnull = {"z": rng.random(m) < 0.3, "k": rng.random(m) < 0.2}
    elif name == "max_pairs":
        max_pairs = 7
    elif name == "empty":
        right["k"] = right["k"] + 100.0                        # no key in common
    elif name == "unique_keys":
        left["k"] = rng.permutation(n).astype(np.float32)
        right["k"] = rng.permutation(np.arange(10, 10 + m)).astype(np.float32)
    elif name == "negative_zero":
        left["x"][::3] = -0.0
        right["z"][::2] = -0.0
    return _both(left, lnull), _both(right, rnull), max_pairs


CASES = ["dangles", "key_not_first", "nulls", "max_pairs", "empty", "unique_keys",
         "negative_zero"]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def _same_join(r_res, t_res):
    (rt, ri), (tt, ti) = r_res, t_res
    assert tt.columns == rt.columns
    np.testing.assert_array_equal(_bits(tt.data.numpy()), _bits(rt.data))
    np.testing.assert_array_equal(tt.null.numpy(), rt.null)
    np.testing.assert_array_equal(tt.index.numpy(), rt.index)
    assert ti.join_pairs.dtype == torch.int32
    np.testing.assert_array_equal(ti.join_pairs.numpy(), ri.join_pairs)
    assert (ti.op_name, ti.n_out, list(ti.n_in)) == (ri.op_name, int(ri.n_out), list(ri.n_in))
    for ra, ta in zip(ri.attr_maps, ti.attr_maps):
        assert ra.kind == ta.kind
        np.testing.assert_array_equal(ta.bitset.words.numpy().view(np.uint32), ra.bitset.words)
        np.testing.assert_array_equal(ta.perm.numpy(), ra.perm)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("how", HOWS)
def test_join_matches_reference_bit_for_bit(how, case):
    (r_l, t_l), (r_r, t_r), max_pairs = _case(case, seed=len(case))
    _same_join(RO.join(r_l, r_r, "k", how, max_pairs=max_pairs),
               TO.join(t_l, t_r, "k", how, max_pairs=max_pairs))


@pytest.mark.parametrize("how", HOWS)
def test_plain_join_gather_matches_reference(how):
    """The plain version on ``repro``'s own pairs gives ``repro``'s table."""
    (r_l, t_l), (r_r, t_r), _ = _case("key_not_first", seed=3)
    rt, ri = RO.join(r_l, r_r, "k", how)
    pairs = torch.from_numpy(np.asarray(ri.join_pairs, dtype=np.int32))
    data, null = TK.join_gather(t_l.data, t_l.null, t_r.data, t_r.null, pairs,
                                t_l.cid("k"), t_r.cid("k"))
    np.testing.assert_array_equal(_bits(data.numpy()), _bits(rt.data))
    np.testing.assert_array_equal(null.numpy(), rt.null)


@pytest.mark.parametrize("how", HOWS)
def test_one_dispatch_a_join(how):
    (_, t_l), (_, t_r), _ = _case("dangles", seed=5)
    TK.reset_launch_counts()
    TO.join(t_l, t_r, "k", how)
    assert TK.launch_counts() == {"join_gather": 1, "join_match": 1}
    TO.join(t_l, t_r, "k", how, max_pairs=3)
    assert TK.launch_counts() == {"join_gather": 2, "join_match": 2}
    TK.reset_launch_counts()


# -- the kernel's walk, modelled in numpy ---------------------------------------------
def kernel_model(ldata, lnull, rdata, rnull, pairs, lkey, rkey):
    """What ``join_gather_kernel`` writes, warp by warp and lane by lane,
    with its (row, column) stepping and column map; asserts that each
    lane's shuffle source is a lane of the warp and its word's position is
    the one it steps to, and that every output word is written once."""
    nl, cl = ldata.shape
    nr, cr = rdata.shape
    n, c_out = len(pairs), cl + cr - 1
    lw, rw = ldata.view(np.uint32).ravel(), rdata.view(np.uint32).ravel()
    ln, rn = lnull.astype(np.uint8).ravel(), rnull.astype(np.uint8).ravel()
    out = np.zeros(n * c_out, np.uint32)
    onull = np.zeros(n * c_out, np.uint8)
    written = np.zeros(n * c_out, np.int64)
    step_rows, step_cols = 32 // c_out, 32 % c_out
    for row0 in range(0, n, 32):
        rows = min(32, n - row0)
        li, ri = [-1] * 32, [-1] * 32
        for lane in range(rows):
            p, q = int(pairs[row0 + lane, 0]), int(pairs[row0 + lane, 1])
            li[lane] = p if 0 <= p < nl else -1
            ri[lane] = q if 0 <= q < nr else -1
        words, base = rows * c_out, row0 * c_out
        for lane in range(32):
            r, c = lane // c_out, lane % c_out
            for k in range(c_out):
                w = lane + 32 * k
                assert 0 <= r < 32 and r * c_out + c == w
                l, q = li[r], ri[r]
                src = None
                if c == 0:
                    if l >= 0:
                        src, srcn, off = lw, ln, l * cl + lkey
                    elif q >= 0:
                        src, srcn, off = rw, rn, q * cr + rkey
                elif c < cl:
                    a = c - 1
                    if l >= 0:
                        src, srcn, off = lw, ln, l * cl + a + (a >= lkey)
                else:
                    a = c - cl
                    if q >= 0:
                        src, srcn, off = rw, rn, q * cr + a + (a >= rkey)
                if w < words:
                    out[base + w] = src[off] if src is not None else 0
                    onull[base + w] = srcn[off] if src is not None else 1
                    written[base + w] += 1
                c += step_cols
                r += step_rows
                if c >= c_out:
                    c -= c_out
                    r += 1
    assert (written == 1).all()
    return out.view(np.float32).reshape(n, c_out), onull.astype(bool).reshape(n, c_out)


def _random_operands(rng, n, cl, cr, nl=9, nr=11):
    ldata = rng.normal(size=(nl, cl)).astype(np.float32)
    rdata = rng.normal(size=(nr, cr)).astype(np.float32)
    lnull, rnull = rng.random((nl, cl)) < 0.3, rng.random((nr, cr)) < 0.3
    side = rng.integers(0, 3, n)                       # 0 both, 1 left only, 2 right only
    pairs = np.stack([np.where(side == 2, -1, rng.integers(0, nl, n)),
                      np.where(side == 1, -1, rng.integers(0, nr, n))], axis=1).astype(np.int32)
    return ldata, lnull, rdata, rnull, pairs


@pytest.mark.parametrize("cl,cr", [(1, 1), (1, 2), (2, 1), (3, 5), (21, 15), (16, 17),
                                   (17, 17), (32, 1), (40, 30)])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 70])
def test_kernel_model_matches_plain_version(cl, cr, n):
    rng = np.random.default_rng(cl * 100 + cr * 7 + n)
    ldata, lnull, rdata, rnull, pairs = _random_operands(rng, n, cl, cr)
    lkey, rkey = int(rng.integers(0, cl)), int(rng.integers(0, cr))
    got_data, got_null = kernel_model(ldata, lnull, rdata, rnull, pairs, lkey, rkey)
    want_data, want_null = ref.join_gather_ref(
        torch.from_numpy(ldata), torch.from_numpy(lnull), torch.from_numpy(rdata),
        torch.from_numpy(rnull), torch.from_numpy(pairs), lkey, rkey)
    np.testing.assert_array_equal(_bits(got_data), _bits(want_data.numpy()))
    np.testing.assert_array_equal(got_null, want_null.numpy())


def test_kernel_model_treats_rows_outside_a_table_as_absent():
    """A pair's row outside its table reads nothing: 0.0 and null, the key
    from the other side."""
    rng = np.random.default_rng(1)
    ldata, lnull, rdata, rnull, _ = _random_operands(rng, 0, 4, 3, nl=5, nr=6)
    pairs = np.array([[5, 2], [1, 6], [1, -7]], dtype=np.int32)
    data, null = kernel_model(ldata, lnull, rdata, rnull, pairs, 1, 0)
    np.testing.assert_array_equal(data[0], [rdata[2, 0], 0, 0, 0, rdata[2, 1], rdata[2, 2]])
    assert null[0, 1:4].all() and null[1, 4:].all() and null[2, 4:].all()
    np.testing.assert_array_equal(data[1, :4], [ldata[1, 1], ldata[1, 0], ldata[1, 2],
                                                ldata[1, 3]])


# -- operand checks ----------------------------------------------------------------
def _operands():
    rng = np.random.default_rng(2)
    ldata, lnull, rdata, rnull, pairs = _random_operands(rng, 10, 4, 3)
    return [torch.from_numpy(a) for a in (ldata, lnull, rdata, rnull, pairs)] + [0, 0]


BAD = {
    "float64 data": lambda a: a.__setitem__(0, a[0].double()),
    "uint8 null": lambda a: a.__setitem__(3, a[3].to(torch.uint8)),
    "int64 pairs": lambda a: a.__setitem__(4, a[4].long()),
    "transposed data": lambda a: a.__setitem__(2, a[2].t().contiguous().t()),
    "strided pairs": lambda a: a.__setitem__(4, torch.stack([a[4][:, 0], a[4][:, 1]])
                                             .t()),
    "null of another shape": lambda a: a.__setitem__(1, a[1][:, :3].contiguous()),
    "pairs of three columns": lambda a: a.__setitem__(4, torch.zeros((10, 3),
                                                                    dtype=torch.int32)),
    "1-D pairs": lambda a: a.__setitem__(4, a[4].reshape(-1)),
    "key past the columns": lambda a: a.__setitem__(6, 3),
    "negative key": lambda a: a.__setitem__(5, -1),
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_operand_checks_raise(what):
    args = _operands()
    TK.join_gather(*args)
    BAD[what](args)
    with pytest.raises(ValueError, match="join_gather"):
        TK.join_gather(*args)
