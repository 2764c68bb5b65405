"""Fill each listed column's nulls with a statistic of its other values."""
import numpy as np

from provbench.reference.ops import same_shape


def apply(cur, sources, rnd, cols, strategy):
    data, null = cur.data.copy(), cur.null.copy()
    for c in cols:
        j = cur.columns.index(c)
        valid = ~null[:, j]
        v = data[valid, j]
        fill = {"mean": np.mean, "median": np.median}[strategy](v) if v.size else 0.0
        data[~valid, j] = fill
        null[:, j] = False
    return same_shape(cur, rnd(data), null)
