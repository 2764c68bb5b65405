"""A per-cell function of one column."""
import numpy as np

from provbench.reference.ops import same_shape, with_column

FNS = {
    "clip": lambda x, lo=-np.inf, hi=np.inf: np.clip(x, lo, hi),
    "binarize": lambda x, threshold: (x > threshold).astype(np.float32),
}


def apply(cur, sources, rnd, col, fn, **params):
    return same_shape(cur, with_column(cur, col, FNS[fn](cur.col(col), **params), rnd))
