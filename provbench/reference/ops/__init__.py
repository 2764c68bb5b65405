"""One module per pipeline op: ``apply(cur, sources, rnd, **args)`` returns
the output table and, per input, ``(input, row_gather, col_gather)``: the
input's name (``"cur"`` for the table the op runs on), and for each output
row and column the input row and column it comes from (-1: none)."""
import numpy as np

from provbench.hosttable import HostTable


def same_shape(cur: HostTable, data: np.ndarray, null=None):
    """A row- and column-preserving op's output and its identity relation."""
    out = HostTable(list(cur.columns), data, cur.null if null is None else null)
    return out, [("cur", np.arange(cur.n_rows), np.arange(cur.n_cols))]


def with_column(cur: HostTable, col: str, values: np.ndarray, rnd):
    data = cur.data.copy()
    data[:, cur.columns.index(col)] = rnd(values)
    return data
