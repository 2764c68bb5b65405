"""Keep the listed columns, in the listed order."""
import numpy as np

from provbench.hosttable import HostTable


def apply(cur, sources, rnd, cols):
    keep = np.array([cur.columns.index(c) for c in cols])
    out = HostTable([cur.columns[j] for j in keep], cur.data[:, keep], cur.null[:, keep])
    return out, [("cur", np.arange(cur.n_rows), keep)]
