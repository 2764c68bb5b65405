"""Inner equi-join of the current table with the source ``right``, bag
semantics: each left row in order, with its matching right rows in the
order of a stable sort of the right keys.  Output columns: the key, the
left's other columns, the right's other columns (a name both sides have
gets ``_l`` / ``_r``).

``max_pairs`` stops the join after that many output rows.  A join whose
keys stay exact never reaches it; it bounds the control, whose keys
rounded to bfloat16 would match each left row to thousands of right
rows."""
import numpy as np

from provbench.hosttable import HostTable


def apply(cur, sources, rnd, right, on, how="inner", max_pairs=None):
    if how != "inner":
        raise ValueError(f"the reference joins inner only, not {how!r}")
    rt = sources[right]
    lk, rk = cur.col(on), rt.col(on)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    counts = np.searchsorted(rk_sorted, lk, side="right") - lo
    if max_pairs is None:
        max_pairs = 2 * (cur.n_rows + rt.n_rows)
    ends = np.cumsum(counts)
    n_left = int(np.searchsorted(ends, max_pairs, side="right"))
    counts = counts[:n_left]
    total = int(counts.sum())
    l_rows = np.repeat(np.arange(n_left), counts)
    starts = np.repeat(lo[:n_left] - (np.cumsum(counts) - counts), counts)
    r_rows = order[starts + np.arange(total)]

    l_cols = [c for c in cur.columns if c != on]
    r_cols = [c for c in rt.columns if c != on]
    names = [on] + [f"{c}_l" if c in r_cols else c for c in l_cols] \
        + [f"{c}_r" if c in l_cols else c for c in r_cols]
    lj = np.array([cur.columns.index(c) for c in [on] + l_cols])
    rj = np.array([rt.columns.index(c) for c in r_cols])
    data = np.concatenate([cur.data[l_rows][:, lj], rt.data[r_rows][:, rj]], axis=1)
    null = np.concatenate([cur.null[l_rows][:, lj], rt.null[r_rows][:, rj]], axis=1)
    n_out_cols = len(names)
    l_colmap = np.full(n_out_cols, -1)
    l_colmap[: len(lj)] = lj
    r_colmap = np.full(n_out_cols, -1)
    r_colmap[0] = rt.columns.index(on)
    r_colmap[len(lj):] = rj
    return HostTable(names, data, null), [("cur", l_rows, l_colmap),
                                         (right, r_rows, r_colmap)]
