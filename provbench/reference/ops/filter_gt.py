"""Keep the rows whose ``col`` exceeds ``value``."""
import numpy as np

from provbench.hosttable import HostTable


def apply(cur, sources, rnd, col, value, op_name=None):
    kept = np.nonzero(cur.col(col) > value)[0]
    out = HostTable(list(cur.columns), cur.data[kept], cur.null[kept])
    return out, [("cur", kept, np.arange(cur.n_cols))]
