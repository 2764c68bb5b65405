"""One table of ``rows`` records shaped as UCI Adult: a categorical column
for each entry of ``domains`` (``a0``...), codes drawn uniformly from [0,
domain), then ``numeric`` standard normal columns; each cell is null with
probability ``null_frac``."""
import numpy as np

from provbench.hosttable import HostTable


def make(params: dict, rng: np.random.Generator) -> dict:
    n, domains, k = params["rows"], params["domains"], params["numeric"]
    m = len(domains) + k
    data = np.empty((n, m), dtype=np.float32)
    for j, d in enumerate(domains):
        data[:, j] = rng.integers(0, d, size=n)
    data[:, len(domains):] = rng.standard_normal((n, k), dtype=np.float32)
    null = rng.random((n, m)) < params["null_frac"]
    return {params["name"]: HostTable([f"a{j}" for j in range(m)], data, null)}
