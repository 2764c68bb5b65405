"""Carrying an index across: plain records in, a device-resident index out.

An index is the state of this system.  :func:`index_from_numpy` builds a
port :class:`~repro_torch.core.pipeline.ProvenanceIndex` from plain Python
and numpy records — the form any other implementation can export, e.g.
``ProvTensor.to_payload()`` of the JAX package — and moves every payload
array to ``device`` in one copy each.  It takes numpy only; nothing here
reads another package.

``datasets`` is a list of dicts with ``id``, ``n_rows``, ``n_cols``,
``columns`` and optional ``is_source`` / ``is_sink`` flags.  ``ops`` is a
list of dicts, in topological (registration) order, with ``op_name``,
``category`` (an :class:`~repro_torch.core.opcat.OpCategory` value string),
``contextual``, ``input_ids``, ``output_id`` and ``payload``: the
``(meta, arrays)`` pair of the op's provenance tensor.  Tables are not
carried: the index answers record-level queries without them.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from repro_torch.core.opcat import CaptureInfo, OpCategory
from repro_torch.core.pipeline import DatasetRecord, ProvenanceIndex
from repro_torch.core.provtensor import ProvTensor

__all__ = ["index_from_numpy"]


def index_from_numpy(datasets: Iterable[Mapping], ops: Iterable[Mapping],
                     device=None) -> ProvenanceIndex:
    index = ProvenanceIndex("carried", device=device)
    for d in datasets:
        index.add_dataset(DatasetRecord(
            dataset_id=str(d["id"]),
            n_rows=int(d["n_rows"]),
            n_cols=int(d["n_cols"]),
            columns=list(d["columns"]),
            is_source=bool(d.get("is_source", False)),
            is_sink=bool(d.get("is_sink", False)),
        ))
    for op in ops:
        meta, arrays = op["payload"]
        tensor = ProvTensor.from_payload(meta, arrays, device=index.device)
        input_ids = [str(i) for i in op["input_ids"]]
        output_id = str(op["output_id"])
        for k, d in enumerate(input_ids):
            if index.datasets[d].n_rows != tensor.n_in[k]:
                raise ValueError(f"{op['op_name']}: input {d} has "
                                 f"{index.datasets[d].n_rows} rows, tensor says {tensor.n_in[k]}")
        if index.datasets[output_id].n_rows != tensor.n_out:
            raise ValueError(f"{op['op_name']}: output {output_id} has "
                             f"{index.datasets[output_id].n_rows} rows, tensor says {tensor.n_out}")
        info = CaptureInfo(
            op_name=str(op["op_name"]),
            category=OpCategory(op["category"]),
            contextual=bool(op["contextual"]),
            n_out=tensor.n_out,
            n_in=list(tensor.n_in),
        )
        index.add_op(info, tensor, input_ids, output_id)
    return index
