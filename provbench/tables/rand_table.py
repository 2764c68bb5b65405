"""One table of ``rows`` x ``cols``: the first ``categorical`` columns are
integer codes in [0, 4 + j % 5), the rest normal with sd 1 + j % 3, and
each cell is null with probability ``null_frac`` (columns ``a0``...)."""
import numpy as np

from provbench.hosttable import HostTable


def make(params: dict, rng: np.random.Generator) -> dict:
    n, m, n_cat = params["rows"], params["cols"], params["categorical"]
    data = np.empty((n, m), dtype=np.float32)
    null = np.empty((n, m), dtype=bool)
    for j in range(m):
        if j < n_cat:
            data[:, j] = rng.integers(0, 4 + j % 5, size=n)
        else:
            data[:, j] = rng.normal(0, 1 + j % 3, size=n)
        null[:, j] = rng.random(n) < params["null_frac"]
    return {params["name"]: HostTable([f"a{j}" for j in range(m)], data, null)}
