"""Columnar Table on a device — the substrate the port instruments.

One float32 value matrix + a null mask + a preserved int64 index, all on
the table's device.  Categorical values are integer codes in float32 (a
``vocab`` per column keeps the labels).  The preserved ``index`` is what
the hybrid capture exploits for index-preserving operations (§III-B).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.spans import count_host_copy

__all__ = ["Table"]


def _to(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


@dataclasses.dataclass
class Table:
    columns: List[str]
    data: torch.Tensor                    # (n_rows, n_cols) float32
    null: Optional[torch.Tensor]          # (n_rows, n_cols) bool
    index: Optional[torch.Tensor]         # (n_rows,) int64, dataframe index
    vocab: Dict[str, list] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not isinstance(self.data, torch.Tensor):
            raise TypeError("Table.data must be a tensor; use Table.from_columns "
                            "to build a table from numpy columns")
        dev = self.data.device
        self.data = self.data.to(torch.float32)
        if self.data.ndim != 2:
            raise ValueError("data must be 2-D (rows x cols)")
        n, c = self.data.shape
        if len(self.columns) != c:
            raise ValueError(f"{len(self.columns)} names for {c} columns")
        if self.null is None:
            self.null = torch.zeros((n, c), dtype=torch.bool, device=dev)
        self.null = _to(self.null, torch.bool, dev)
        if self.index is None:
            self.index = torch.arange(n, dtype=torch.int64, device=dev)
        self.index = _to(self.index, torch.int64, dev)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_columns(cols: Dict[str, object], null: Optional[Dict[str, object]] = None,
                     device=None) -> "Table":
        """Columns (numpy arrays or tensors) -> a table on ``device``
        (``None`` -> CUDA, raising without a card)."""
        dev = resolve_device(device)
        names = list(cols)
        data = torch.stack([_to(cols[c], torch.float32, dev) for c in names], dim=1)
        nullm = torch.zeros_like(data, dtype=torch.bool)
        if null:
            for j, c in enumerate(names):
                if c in null:
                    nullm[:, j] = _to(null[c], torch.bool, dev)
        nullm |= torch.isnan(data)
        return Table(columns=names, data=data, null=nullm,
                     index=torch.arange(data.shape[0], dtype=torch.int64, device=dev))

    # -- shape ----------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.data.shape[1])

    def col(self, name: str) -> torch.Tensor:
        return self.data[:, self.columns.index(name)]

    def col_null(self, name: str) -> torch.Tensor:
        return self.null[:, self.columns.index(name)]

    def cid(self, name: str) -> int:
        return self.columns.index(name)

    # -- row/col selection (no provenance — used internally) ------------------
    def take_rows(self, rows: torch.Tensor, keep_index: bool = True) -> "Table":
        rows = rows.to(torch.int64)
        return Table(
            columns=list(self.columns),
            data=self.data[rows],
            null=self.null[rows],
            index=self.index[rows] if keep_index else
            torch.arange(len(rows), dtype=torch.int64, device=self.device),
            vocab=dict(self.vocab),
        )

    def take_cols(self, names: Sequence[str]) -> "Table":
        ids = [self.columns.index(c) for c in names]
        count_host_copy(self.device, 2)     # the column list, for data and nulls
        return Table(
            columns=list(names),
            data=self.data[:, ids],
            null=self.null[:, ids],
            index=self.index.clone(),
            vocab={c: v for c, v in self.vocab.items() if c in names},
        )

    def copy(self) -> "Table":
        return Table(
            columns=list(self.columns),
            data=self.data.clone(),
            null=self.null.clone(),
            index=self.index.clone(),
            vocab=dict(self.vocab),
        )

    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in (self.data, self.null, self.index))

    def row_tuple(self, i: int) -> tuple:
        """Value identity of a row (nulls as NaN, zeros as ``-0.0``) — used
        by set-semantics canonicalization and frame diffing."""
        vals = self.data[i].clone()
        vals[self.null[i]] = float("nan")
        return tuple(-0.0 if v == 0 else v for v in vals.tolist())

    def duplicate_groups(self) -> torch.Tensor:
        """Set-semantics support (paper §III-C.a): ``groups[i]`` = smallest
        row index whose VALUES (bit patterns, nulls as NaN) equal row i's."""
        clean = torch.where(self.null, torch.full_like(self.data, float("nan")), self.data)
        bits = clean.view(torch.int32)
        _, inverse = torch.unique(bits, dim=0, return_inverse=True)
        rows = torch.arange(self.n_rows, dtype=torch.int64, device=self.device)
        first = torch.full((self.n_rows,), self.n_rows, dtype=torch.int64, device=self.device)
        first = first.scatter_reduce(0, inverse, rows, reduce="amin")
        return first[inverse].to(torch.int32)
