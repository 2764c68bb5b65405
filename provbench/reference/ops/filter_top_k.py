"""Keep the k rows of largest ``col`` (nulls by their stored value), ties
broken by row order."""
import numpy as np

from provbench.hosttable import HostTable


def apply(cur, sources, rnd, col, k, op_name=None):
    vals = cur.col(col)
    thresh = np.sort(vals)[len(vals) - k]
    kept = np.nonzero(vals >= thresh)[0][:k]
    out = HostTable(list(cur.columns), cur.data[kept], cur.null[kept])
    return out, [("cur", kept, np.arange(cur.n_cols))]
