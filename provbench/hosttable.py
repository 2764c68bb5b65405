"""Host tables and seeded streams: the inputs both sides receive.

Tables are made on the host from the seed, moved to the card once in
set-up, and handed unchanged to the plain reference.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class HostTable:
    """A table as the benchmark made it: float32 values, null flags."""

    columns: List[str]
    data: np.ndarray        # (n_rows, n_cols) float32
    null: np.ndarray        # (n_rows, n_cols) bool

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.data.shape[1])

    def col(self, name: str) -> np.ndarray:
        return self.data[:, self.columns.index(name)]


# Independent streams drawn from one seed.
TABLES, PROBES, WARMUP, SAMPLE = 0, 1, 2, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed``; any whole number is a seed
    (negative ones and those past 64 bits wrap)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])
