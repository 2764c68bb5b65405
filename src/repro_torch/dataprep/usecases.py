"""The paper's three use-case pipelines + TPC-DI-style synthetic join data.

Shapes follow Table VIII exactly:

  German  4 ops  1000  rows  21 attrs ->  1000 rows  60 attrs
  Compas  7 ops  7214  rows  53 attrs ->  6907 rows   8 attrs
  Census  5 ops  32561 rows  15 attrs -> 32561 rows 104 attrs

The content is synthetic, drawn from the same numpy seeds as ``repro``'s
use cases (so both packages capture the same tables), then moved to the
requested device in one copy per column.  The TPC-DI generator reproduces
Table XI's join cardinalities per scale factor.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import TrackedTable, track

__all__ = [
    "make_german",
    "make_compas",
    "make_census",
    "run_german",
    "run_compas",
    "run_census",
    "make_tpcdi_join_inputs",
    "USECASES",
    "STEPS",
    "run_steps",
    "TPCDI_SCALES",
]


def run_steps(d: TrackedTable, steps) -> TrackedTable:
    """Apply ``steps`` (callables on a tracked table) in order."""
    for step in steps:
        d = step(d)
    return d


def _rand_table(n_rows: int, n_cols: int, n_cat: int, seed: int, device,
                null_frac: float = 0.02) -> Table:
    rng = np.random.default_rng(seed)
    cols = {}
    nulls = {}
    for j in range(n_cols):
        name = f"a{j}"
        if j < n_cat:
            cols[name] = rng.integers(0, 4 + j % 5, size=n_rows).astype(np.float32)
        else:
            cols[name] = rng.normal(0, 1 + j % 3, size=n_rows).astype(np.float32)
        nulls[name] = rng.random(n_rows) < null_frac
    return Table.from_columns(cols, null=nulls, device=device)


# ---------------------------------------------------------------------------
# German credit: 1000 x 21 -> 1000 x 60 in 4 ops
# ---------------------------------------------------------------------------
def make_german(seed: int = 0, device=None) -> Table:
    return _rand_table(1000, 21, n_cat=13, seed=seed, device=device)


GERMAN_STEPS = [
    lambda d: d.impute([f"a{j}" for j in range(13, 21)], strategy="mean"),    # 1
    lambda d: d.normalize([f"a{j}" for j in range(13, 21)], kind="zscore"),   # 2
    lambda d: d.onehot("a0", n_values=9),                                     # 3: 21+9=30
    lambda d: d.onehot("a1", n_values=30),                                    # 4: 30+30=60
]


def run_german(index: ProvenanceIndex, t: Table) -> TrackedTable:
    return run_steps(track(t, index, "german_src"), GERMAN_STEPS).mark_sink()


# ---------------------------------------------------------------------------
# Compas: 7214 x 53 -> 6907 x 8 in 7 ops
# ---------------------------------------------------------------------------
def make_compas(seed: int = 1, device=None) -> Table:
    return _rand_table(7214, 53, n_cat=20, seed=seed, device=device)


def _compas_filter(d: TrackedTable) -> TrackedTable:
    """Keep the top-6907 rows by a21 (value-driven threshold, exact Table
    VIII count)."""
    vals = d.table.col("a21")
    thresh = torch.kthvalue(vals, len(vals) - 6907 + 1).values  # np.partition's pick
    count(HOST_SYNCS)
    kept = torch.nonzero(vals >= thresh).reshape(-1)[:6907]
    m2 = torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
    m2[kept] = True
    count_host_copy(vals.device)
    return d.filter_rows(m2, op_name="filter:days_b_screening")


COMPAS_STEPS = [
    lambda d: d.impute(["a25", "a30"], strategy="median"),                    # 1
    _compas_filter,                                                           # 2 -> 6907 rows
    lambda d: d.value_transform("a22", "clip", lo=-3.0, hi=3.0),              # 3
    lambda d: d.binarize("a23", threshold=0.0),                               # 4
    lambda d: d.discretize("a24", n_bins=4, kind="quantile"),                 # 5
    lambda d: d.normalize(["a22"], kind="minmax"),                            # 6
    lambda d: d.select_columns([f"a{j}" for j in (0, 5, 21, 22, 23, 24, 25, 30)]),  # 7 -> 8 attrs
]


def run_compas(index: ProvenanceIndex, t: Table) -> TrackedTable:
    return run_steps(track(t, index, "compas_src"), COMPAS_STEPS).mark_sink()


# ---------------------------------------------------------------------------
# Census (adult): 32561 x 15 -> 32561 x 104 in 5 ops
# ---------------------------------------------------------------------------
def make_census(seed: int = 2, device=None) -> Table:
    return _rand_table(32561, 15, n_cat=9, seed=seed, device=device)


CENSUS_STEPS = [
    lambda d: d.impute([f"a{j}" for j in range(9, 15)], strategy="mean"),     # 1
    lambda d: d.normalize([f"a{j}" for j in range(9, 15)], kind="zscore"),    # 2
    lambda d: d.onehot("a0", n_values=9),                                     # 3: 15+9=24
    lambda d: d.onehot("a1", n_values=16),                                    # 4: 24+16=40
    lambda d: d.onehot("a2", n_values=64),                                    # 5: 40+64=104
]


def run_census(index: ProvenanceIndex, t: Table) -> TrackedTable:
    return run_steps(track(t, index, "census_src"), CENSUS_STEPS).mark_sink()


USECASES: Dict[str, Tuple[Callable[..., Table], Callable]] = {
    "german": (make_german, run_german),
    "compas": (make_compas, run_compas),
    "census": (make_census, run_census),
}

# each use case's op list, so a pipeline can also be captured in pieces
# (e.g. split across the indexes of a federation at any op)
STEPS: Dict[str, List[Callable[[TrackedTable], TrackedTable]]] = {
    "german": GERMAN_STEPS,
    "compas": COMPAS_STEPS,
    "census": CENSUS_STEPS,
}


# ---------------------------------------------------------------------------
# TPC-DI-like synthetic join inputs (Table XI cardinalities per scale factor)
# ---------------------------------------------------------------------------
TPCDI_SCALES = {
    3: (362342, 390978),
    5: (602956, 650412),
    9: (1085239, 1171107),
    15: (1807703, 1951236),
    20: (2411006, 2601648),
}


def make_tpcdi_join_inputs(scale: int, seed: int = 7, n_attrs: int = 8,
                           device=None) -> Tuple[Table, Table]:
    """Two key-sharing tables whose inner join has ~|left| matches (each left
    row matches one right row, as TPC-DI's surrogate-key joins do)."""
    n_l, n_r = TPCDI_SCALES[scale]
    rng = np.random.default_rng(seed)
    right_keys = np.arange(n_r, dtype=np.float32)
    left_keys = rng.choice(n_r, size=n_l, replace=False).astype(np.float32) \
        if n_l <= n_r else rng.integers(0, n_r, size=n_l).astype(np.float32)
    lcols = {"key": left_keys}
    rcols = {"key": right_keys}
    for j in range(n_attrs - 1):
        lcols[f"l{j}"] = rng.normal(size=n_l).astype(np.float32)
        rcols[f"r{j}"] = rng.normal(size=n_r).astype(np.float32)
    return (Table.from_columns(lcols, device=device),
            Table.from_columns(rcols, device=device))
