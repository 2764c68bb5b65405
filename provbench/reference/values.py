"""Q1/Q2 answers that carry values: the rows of the dataset a pipeline
step outputs (step ``to``, the target) that each probe reaches, and the
target's values at those rows.

The configuration's reference ops are applied step by step, as
``lineage.run_pipeline`` applies them, and step ``to``'s output is kept.
The row maps from each source to the target are composed op by op up to
it; the map from the sink to the target is composed from the identity on
the target over the later steps.  A probe's answer is its target rows,
ascending, and its values those rows of the target, in that order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import numpy as np

from provbench.hosttable import HostTable
from provbench.reference import rounder
from provbench.reference.lineage import Answers, Lineage, _compose

TARGET = "\0target"      # the target's key among the composed maps: no dataset's name


@dataclasses.dataclass
class Target:
    """Step ``to``'s output and the lineage between it and the rest."""

    table: HostTable
    answers: Answers        # Q1 from a source and Q2 from the sink (source TARGET)
    lineage: Lineage        # the whole pipeline's, as ``run_pipeline`` gives it

    def rows(self, q: str, src: str, probes) -> List[np.ndarray]:
        """Each probe's ascending target rows: Q1 forward from the source
        ``src``, Q2 backward from the sink."""
        if q == "q1":
            return self.answers.answer("q1", src, probes)
        if q == "q2":
            return self.answers.answer("q2", TARGET, probes)
        raise ValueError(f"a values answer is Q1 or Q2, not {q!r}")

    def answer(self, q: str, src: str, probes) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(rows, data, null) a probe: its target rows and their values."""
        return [(r, self.table.data[r], self.table.null[r]) for r in self.rows(q, src, probes)]


def run_to(config: dict, tables: Dict[str, HostTable], to: int,
           precision: str = "float32") -> Target:
    """Apply ``config["pipeline"]`` to the host tables in ``precision``,
    keeping step ``to``'s output as the target."""
    if not 0 <= to < len(config["pipeline"]):
        raise ValueError(f"no pipeline step {to}")
    rnd = rounder(precision)
    tables = {n: HostTable(t.columns, rnd(t.data), t.null) for n, t in tables.items()}
    ident = {n: {n: (np.arange(t.n_rows), np.arange(t.n_cols))} for n, t in tables.items()}
    cur, cur_maps = tables[config["start"]], ident[config["start"]]
    ops, target, to_maps = [], None, None
    for k, step in enumerate(config["pipeline"]):
        mod = importlib.import_module(f"provbench.reference.ops.{step['op']}")
        out, inputs = mod.apply(cur, tables, rnd, **step.get("args", {}))
        maps = {}
        for name, rows, cols in inputs:
            maps.update(_compose(cur_maps if name == "cur" else ident[name], rows, cols))
        ops.append((out.n_rows, out.n_cols, inputs))
        if k == to:
            target, to_maps = out, maps
            maps = {**maps, TARGET: (np.arange(out.n_rows), np.arange(out.n_cols))}
        cur, cur_maps = out, maps
    lineage = Lineage(sink=cur, ops=ops, maps={n: m for n, m in cur_maps.items() if n != TARGET})
    answers = Answers(Lineage(sink=target, ops=[], maps={**to_maps, TARGET: cur_maps[TARGET]}))
    return Target(table=target, answers=answers, lineage=lineage)


def probe_differs(got, want, columns_got, columns_want) -> bool:
    """Whether a probe's (rows, data, null) differ from the reference's:
    its rows or their order, a column, a data bit or a null flag."""
    g_rows, g_data, g_null = got
    w_rows, w_data, w_null = want
    return (list(columns_got) != list(columns_want) or g_rows.shape != w_rows.shape
            or not np.array_equal(g_rows, w_rows) or g_data.shape != w_data.shape
            or not np.array_equal(np.ascontiguousarray(g_data, np.float32).view(np.uint32),
                                  np.ascontiguousarray(w_data, np.float32).view(np.uint32))
            or g_null.shape != w_null.shape or not np.array_equal(g_null, w_null))
