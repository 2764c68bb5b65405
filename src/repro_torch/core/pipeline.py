"""The ProvenanceIndex — the paper's Figure 2 model, resident on a device.

Holds, per pipeline: dataset records, operation records with precedence
(a DAG), each operation's provenance tensor and schema annotations, and
the materialization policy (§III-E): source/sink datasets always kept,
inputs of *contextual* operations materialized, everything else
recomputable.  Every table and tensor the index holds lies on
``index.device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.capture import build_tensor
from repro_torch.core.device import resolve_device
from repro_torch.core.opcat import CaptureInfo
from repro_torch.core.provtensor import ProvTensor
from repro_torch.dataprep.table import Table

__all__ = ["DatasetRecord", "OpRecord", "ProvenanceIndex"]


@dataclasses.dataclass
class DatasetRecord:
    dataset_id: str
    n_rows: int
    n_cols: int
    columns: List[str]
    table: Optional[Table] = None       # materialized content (policy-driven)
    is_source: bool = False
    is_sink: bool = False

    @property
    def materialized(self) -> bool:
        return self.table is not None


@dataclasses.dataclass
class OpRecord:
    op_id: int
    info: CaptureInfo
    tensor: ProvTensor
    input_ids: List[str]
    output_id: str


class ProvenanceIndex:
    """Device-resident index of one pipeline's provenance.

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to hold the index on the host.
    """

    def __init__(self, name: str = "pipeline", device=None, spill=None) -> None:
        if spill is not None and spill is not False:
            raise NotImplementedError(
                "out-of-core spill is not ported yet (ROADMAP A7)")
        self.name = name
        self.device = resolve_device(device)
        self.datasets: Dict[str, DatasetRecord] = {}
        self.ops: List[OpRecord] = []
        self.producer: Dict[str, int] = {}          # dataset -> producing op
        self.consumers: Dict[str, List[int]] = {}   # dataset -> consuming ops
        self._session = None                        # shared QuerySession
        self._record_hooks: List = []               # capture observers

    # -- capture hooks ---------------------------------------------------------
    def add_record_hook(self, fn):
        """Register a capture observer called on every :meth:`record`, after
        input validation and BEFORE the provenance tensor is built, as
        ``fn(input_ids, output_id, out_table, info, input_tables)``.
        Returns ``fn`` so it can be used as a decorator."""
        self._record_hooks.append(fn)
        return fn

    def remove_record_hook(self, fn) -> None:
        self._record_hooks.remove(fn)

    # -- registration ---------------------------------------------------------
    def _check_device(self, table: Table, what: str) -> None:
        if table.device != self.device:
            raise ValueError(f"{what} lies on {table.device}, the index on {self.device}")

    def add_source(self, dataset_id: str, table: Table) -> str:
        """Pipeline input datasets are always materialized (paper §III-E)."""
        self._check_device(table, f"source {dataset_id!r}")
        self.add_dataset(DatasetRecord(
            dataset_id=dataset_id,
            n_rows=table.n_rows,
            n_cols=table.n_cols,
            columns=list(table.columns),
            table=table,
            is_source=True,
        ))
        return dataset_id

    def add_dataset(self, record: DatasetRecord) -> None:
        """Register a dataset record as it is (sources, carried-over state)."""
        self.datasets[record.dataset_id] = record

    def add_op(self, info: CaptureInfo, tensor: ProvTensor,
               input_ids: Sequence[str], output_id: str) -> OpRecord:
        """Append one op record with its tensor and wire it into the DAG."""
        if tensor.device != self.device:
            raise ValueError(f"{info.op_name}: tensor lies on {tensor.device}, "
                             f"the index on {self.device}")
        op = OpRecord(op_id=len(self.ops), info=info, tensor=tensor,
                      input_ids=list(input_ids), output_id=output_id)
        self.ops.append(op)
        self.producer[output_id] = op.op_id
        for d in input_ids:
            self.consumers.setdefault(d, []).append(op.op_id)
        return op

    def record(
        self,
        input_ids: Sequence[str],
        output_id: str,
        out_table: Table,
        info: CaptureInfo,
        keep_output: bool = False,
        input_tables: Optional[Sequence[Table]] = None,
    ) -> str:
        """Register one executed operation.  ``keep_output`` marks pipeline
        sinks (always materialized).  ``input_tables`` lets the §III-E policy
        materialize the inputs of contextual ops (TrackedTable passes them)."""
        if output_id in self.datasets:
            raise ValueError(
                f"{info.op_name}: output dataset {output_id!r} already exists"
            )
        self._check_device(out_table, f"{info.op_name} output")
        for k, d in enumerate(input_ids):
            if d not in self.datasets:
                raise KeyError(f"unknown input dataset {d}")
            if self.datasets[d].n_rows != info.n_in[k]:
                raise ValueError(
                    f"{info.op_name}: input {d} has {self.datasets[d].n_rows} rows, "
                    f"capture says {info.n_in[k]}"
                )
        for hook in self._record_hooks:
            hook(list(input_ids), output_id, out_table, info, input_tables)
        self.add_op(info, build_tensor(info, device=self.device), input_ids, output_id)
        self.add_dataset(DatasetRecord(
            dataset_id=output_id,
            n_rows=out_table.n_rows,
            n_cols=out_table.n_cols,
            columns=list(out_table.columns),
            table=out_table if keep_output else None,
            is_sink=keep_output,
        ))
        # materialization policy: contextual ops keep their INPUT datasets
        if info.contextual:
            for k, d in enumerate(input_ids):
                rec = self.datasets[d]
                if rec.table is None:
                    if input_tables is not None and input_tables[k] is not None:
                        rec.table = input_tables[k]
                    else:
                        raise RuntimeError(
                            f"contextual op {info.op_name} needs materialized input {d}; "
                            "pass input_tables (TrackedTable does this automatically)"
                        )
        return output_id

    # -- graph helpers ---------------------------------------------------------
    def downstream_ops(self, dataset_id: str) -> List[OpRecord]:
        """Ops reachable forward from ``dataset_id``, topologically ordered."""
        reach = {dataset_id}
        out = []
        for op in self.ops:
            if any(d in reach for d in op.input_ids):
                out.append(op)
                reach.add(op.output_id)
        return out

    def upstream_ops(self, dataset_id: str) -> List[OpRecord]:
        """Ops contributing to ``dataset_id``, topologically ordered."""
        reach = {dataset_id}
        out = []
        for op in reversed(self.ops):
            if op.output_id in reach:
                out.append(op)
                reach.update(op.input_ids)
        return list(reversed(out))

    def path_exists(self, src: str, dst: str) -> bool:
        if src == dst:
            return True
        reach = {src}
        for op in self.ops:
            if any(d in reach for d in op.input_ids):
                reach.add(op.output_id)
        return dst in reach

    def sources(self) -> List[str]:
        return [d for d, r in self.datasets.items() if r.is_source]

    def sinks(self) -> List[str]:
        produced = set(self.producer)
        consumed = set(self.consumers)
        return [d for d in produced if d not in consumed]

    def composed(self, **kwargs):
        raise NotImplementedError(
            "the composed hop-cache is not ported yet (ROADMAP A5)")

    def export(self, dataset_id: str):
        raise NotImplementedError(
            "boundary handles (federation) are not ported yet (ROADMAP A8)")

    def session(self, **kwargs):
        """The index's shared :class:`~repro_torch.provenance.session.QuerySession`
        behind ``repro_torch.provenance.prov(index)``.  Pass kwargs (e.g.
        ``fused_walk``) on first call to configure it."""
        from repro_torch.provenance.session import QuerySession  # circular at module scope

        if self._session is None:
            self._session = QuerySession(self, **kwargs)
        elif kwargs:
            raise ValueError("session() already configured; use index.session()")
        return self._session

    # -- memory accounting (Table IX / Table XI) --------------------------------
    def prov_nbytes(self) -> int:
        """Bytes of the provenance encoding proper: tensors (with built
        mirrors) + schema bitsets/permutation lists."""
        total = 0
        for op in self.ops:
            total += op.tensor.nbytes()
            for amap in op.info.attr_maps:
                total += amap.nbytes()
        return total
