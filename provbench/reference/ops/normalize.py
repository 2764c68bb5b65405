"""Rescale each listed column by statistics of its non-null values."""
from provbench.reference.ops import same_shape


def apply(cur, sources, rnd, cols, kind="zscore"):
    data = cur.data.copy()
    for c in cols:
        j = cur.columns.index(c)
        v = data[~cur.null[:, j], j]
        if kind == "minmax":
            lo, hi = (v.min(), v.max()) if v.size else (0.0, 1.0)
            data[:, j] = (data[:, j] - lo) / ((hi - lo) or 1.0)
        else:
            mu, sd = (v.mean(), v.std()) if v.size else (0.0, 1.0)
            data[:, j] = (data[:, j] - mu) / (sd or 1.0)
    return same_shape(cur, rnd(data))
