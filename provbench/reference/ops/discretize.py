"""Replace ``col`` by its bin number: ``n_bins`` bins between quantiles or
of equal width."""
import numpy as np

from provbench.reference.ops import same_shape, with_column


def apply(cur, sources, rnd, col, n_bins, kind="uniform"):
    x = cur.col(col)
    if kind == "quantile":
        edges = np.quantile(x, np.linspace(0, 1, n_bins + 1)[1:-1])
    else:
        edges = np.linspace(x.min(), x.max(), n_bins + 1)[1:-1]
    return same_shape(cur, with_column(cur, col, np.searchsorted(edges, x), rnd))
