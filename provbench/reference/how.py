"""How-provenance of the reference pipeline: per probe of Q7 (forward from
a source) and Q8 (backward from the sink), the ops its term passes.

A term is a set of rows and a set of columns of one dataset.  Through an
op, forward, it becomes the output rows and columns whose gathered input
row and column lie in it; backward, the input rows and columns its
output rows and columns gather.  A hop is recorded where the term leaves
the op with both sets non-empty, as (the op's position in the pipeline,
its Table VI category, the number of distinct rows of the term); the walk
goes on from every such term, over every op it reaches, in pipeline order
forward and in reverse backward, and over an op's inputs in their order.
The gathers are ``run_pipeline``'s, each op's inputs named ``"cur"`` (the
previous op's output, or the start) or a source.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from provbench.reference.lineage import Lineage

# Table VI's category of each op a traced pipeline names (Census's, and
# the row and column reductions of the tests' hand-worked pipeline)
CATEGORIES = {
    "impute": "data_transformation",
    "normalize": "data_transformation",
    "onehot": "vertical_augmentation",
    "select_columns": "vertical_reduction",
    "filter_gt": "horizontal_reduction",
}

Hop = Tuple[int, str, int]


class Traces:
    """Q7/Q8 hop traces over one reference pipeline of ``config``."""

    def __init__(self, config: dict, lin: Lineage):
        self.categories = [CATEGORIES[step["op"]] for step in config["pipeline"]]
        self.ops = []       # per op: (output name, [(input name, rows, cols)])
        for k, (_, _, inputs) in enumerate(lin.ops):
            prev = config["start"] if k == 0 else k - 1
            self.ops.append((k, [(prev if name == "cur" else name, rows, cols)
                                 for name, rows, cols in inputs]))

    def _forward(self, src: str, rows, cols) -> List[Hop]:
        hops: List[Hop] = []
        terms: Dict[object, list] = {src: [(np.unique(rows), np.unique(cols))]}
        for k, inputs in self.ops:
            for name, rg, cg in inputs:
                for r, c in terms.get(name, []):
                    new_r, new_c = np.nonzero(np.isin(rg, r))[0], np.nonzero(np.isin(cg, c))[0]
                    if len(new_r) and len(new_c):
                        hops.append((k, self.categories[k], len(new_r)))
                        terms.setdefault(k, []).append((new_r, new_c))
        return hops

    def _backward(self, rows, cols) -> List[Hop]:
        hops: List[Hop] = []
        sink = len(self.ops) - 1
        terms: Dict[object, list] = {sink: [(np.unique(rows), np.unique(cols))]}
        for k, inputs in reversed(self.ops):
            for r, c in terms.get(k, []):
                for name, rg, cg in inputs:
                    new_r, new_c = np.unique(rg[r]), np.unique(cg[c])
                    new_r, new_c = new_r[new_r >= 0], new_c[new_c >= 0]
                    if len(new_r) and len(new_c):
                        hops.append((k, self.categories[k], len(new_r)))
                        terms.setdefault(name, []).append((new_r, new_c))
        return hops

    def answer(self, q: str, src: str, rows, attrs) -> List[List[Hop]]:
        """One trace a probe: ``rows`` (B, k) and ``attrs`` (B, a) of the
        source (``q7``) or of the sink (``q8``)."""
        if q == "q7":
            return [self._forward(src, rows[b], attrs[b]) for b in range(len(rows))]
        if q == "q8":
            return [self._backward(rows[b], attrs[b]) for b in range(len(rows))]
        raise ValueError(f"no how-trace for query kind {q!r}")


def count_wrong(got: List[List[Hop]], want: List[List[Hop]]) -> int:
    """Probes whose trace differs (a missing trace counts as wrong)."""
    return abs(len(got) - len(want)) + sum(g != w for g, w in zip(got, want))
