"""Two key-sharing tables whose inner join matches every left row to one
right row, as TPC-DI's DimTrade references DimSecurity through
SK_SecurityID: the right keys are 0..right_rows-1, each left key drawn
uniformly among them with replacement (many trades to one security);
``left_cols`` and ``right_cols`` count the key; every other attribute is
standard normal; no nulls."""
import numpy as np

from provbench.hosttable import HostTable


def make(params: dict, rng: np.random.Generator) -> dict:
    n_l, n_r = params["left_rows"], params["right_rows"]
    m_l, m_r = params["left_cols"], params["right_cols"]
    left = np.empty((n_l, m_l), dtype=np.float32)
    right = np.empty((n_r, m_r), dtype=np.float32)
    left[:, 0] = rng.integers(0, n_r, size=n_l)
    right[:, 0] = np.arange(n_r)
    left[:, 1:] = rng.standard_normal((n_l, m_l - 1), dtype=np.float32)
    right[:, 1:] = rng.standard_normal((n_r, m_r - 1), dtype=np.float32)
    return {
        params["left"]: HostTable(["key"] + [f"l{j}" for j in range(m_l - 1)],
                                  left, np.zeros(left.shape, dtype=bool)),
        params["right"]: HostTable(["key"] + [f"r{j}" for j in range(m_r - 1)],
                                   right, np.zeros(right.shape, dtype=bool)),
    }
