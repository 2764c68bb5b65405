"""The query streams a mix sends, drawn on the host from the seed, so both
the port and the reference receive them.

A call is one plan: its kind (Q1 forward records, Q2 backward records,
Q3 forward cells, Q4 backward cells), the source dataset it reads or
answers in, and its probes: ``rows`` (B, k) and, for cells, ``attrs``
(B, a), uniform over the dataset it starts from, a probe's attributes
distinct."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

KINDS = ("q1", "q2", "q3", "q4")


@dataclasses.dataclass
class Call:
    q: str
    src: str
    rows: np.ndarray
    attrs: Optional[np.ndarray]

    @property
    def n_probes(self) -> int:
        return int(self.rows.shape[0])


def draw_call(rng: np.random.Generator, mix: dict, sources: List[str],
              sizes: Dict[str, Tuple[int, int]], sink: str, i: int) -> Call:
    """The ``i``-th call of a stream cycling through ``mix["kinds"]`` (each
    ``{"q": kind, "src": index into the configuration's sources}``), its
    probes drawn from ``rng``.  ``sizes`` maps each dataset to its (rows,
    columns)."""
    batch, k, a = mix["batch"], mix["rows_per_probe"], mix.get("attrs_per_probe", 0)
    kind = mix["kinds"][i % len(mix["kinds"])]
    q, src = kind["q"], sources[kind["src"] % len(sources)]
    if q not in KINDS:
        raise ValueError(f"unknown query kind {q!r}")
    start = src if q in ("q1", "q3") else sink
    n_rows, n_cols = sizes[start]
    rows = rng.integers(0, n_rows, size=(batch, k))
    attrs = None
    if q in ("q3", "q4"):
        attrs = np.argsort(rng.random((batch, n_cols)), axis=1)[:, :a]
    return Call(q, src, rows, attrs)


def query_calls(rng: np.random.Generator, mix: dict, sources: List[str],
                sizes: Dict[str, Tuple[int, int]], sink: str, n_calls: int) -> List[Call]:
    """The first ``n_calls`` calls of ``draw_call``'s stream."""
    return [draw_call(rng, mix, sources, sizes, sink, i) for i in range(n_calls)]
