"""Append a 0/1 column ``col=v`` for each v in [0, n_values): 1 where the
cell of ``col`` is not null and its code (the value cast to int64) is v.
The new columns are never null.  Rows map by identity, the input columns
keep their places, and each new column maps to ``col``."""
import numpy as np

from provbench.hosttable import HostTable


def apply(cur, sources, rnd, col, n_values):
    j = cur.columns.index(col)
    code = cur.data[:, j].astype(np.int64)
    hot = np.zeros((cur.n_rows, n_values), dtype=np.float32)
    set_ = np.nonzero((code >= 0) & (code < n_values) & ~cur.null[:, j])[0]
    hot[set_, code[set_]] = 1.0
    out = HostTable(list(cur.columns) + [f"{col}={v}" for v in range(n_values)],
                    np.concatenate([cur.data, rnd(hot)], axis=1),
                    np.concatenate([cur.null, np.zeros(hot.shape, dtype=bool)], axis=1))
    cols = np.concatenate([np.arange(cur.n_cols), np.full(n_values, j)])
    return out, [("cur", np.arange(cur.n_rows), cols)]
