"""The benchmark's calls into the port: tables to the device, the
pipeline's capture, the plans of Q1-Q4, and the port's outputs read back
to the host for judging.  ``repro_torch`` is imported here and in
``steps/``; the reference never imports either."""
from __future__ import annotations

import importlib
import time
from typing import Dict, List

import numpy as np
import torch

from provbench.hosttable import HostTable


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def to_device(t: HostTable, device):
    """One copy of the values and one of the null flags."""
    from repro_torch.dataprep.table import Table

    return Table(columns=list(t.columns), data=torch.from_numpy(t.data).to(device),
                 null=torch.from_numpy(t.null).to(device), index=None)


def capture(config: dict, tables: Dict[str, object], device, spans=None):
    """Run the configuration's pipeline over the device ``tables`` into a
    fresh ``ProvenanceIndex``.  Returns (index, sink dataset id).  With
    ``spans`` (a dict of lists), each step that names a ``span`` is timed
    on the host clock up to a synchronise under ``capture.<span>``."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.tracked import track

    index = ProvenanceIndex(config["name"], device=device)
    sources = {name: track(tables[name], index, name) for name in config["sources"]}
    cur = sources[config["start"]]
    for step in config["pipeline"]:
        timed = spans is not None and "span" in step
        if timed:
            sync(device)
            t = time.perf_counter()
        cur = apply_step(cur, sources, step)
        if timed:
            sync(device)
            spans.setdefault(f"capture.{step['span']}", []).append(time.perf_counter() - t)
    cur.mark_sink()
    return index, cur.dataset_id


def apply_step(cur, sources, step: dict):
    """``steps/<op>.py``'s ``apply`` where the op has one, else the tracked
    table's method of the op's name."""
    args = step.get("args", {})
    try:
        mod = importlib.import_module(f"provbench.steps.{step['op']}")
    except ModuleNotFoundError as exc:
        if exc.name != f"provbench.steps.{step['op']}":
            raise
        return getattr(cur, step["op"])(**args)
    return mod.apply(cur, sources, **args)


def build_plan(index, sink: str, call) -> object:
    """The ``QueryPlan`` of one call of a query stream (``traffic.Call``)."""
    from repro_torch.provenance import prov

    q = prov(index)
    if call.q in ("q1", "q3"):
        q = q.source(call.src).forward().to(sink)
    else:
        q = q.source(sink).backward().to(call.src)
    q = q.rows_batch(call.rows)
    if call.attrs is not None:
        q = q.attrs_batch(call.attrs)
    return q.plan()


def answers_to_host(result) -> List[np.ndarray]:
    """A batched plan's answer, one tensor a probe, as numpy arrays."""
    return [torch.as_tensor(a).cpu().numpy() for a in result]


def relations_to_host(index) -> list:
    """Every op of ``index`` as the reference states them: (n_out rows,
    n_out cols, [(input, row gather, col gather)]).  An output row or column
    linked to several inputs rows or columns reads -2, which no reference
    gather holds."""
    out = []
    for op in index.ops:
        n_out = op.info.n_out
        n_out_cols = index.datasets[op.output_id].n_cols
        inputs = []
        for k, name in enumerate(op.input_ids):
            csr = op.tensor.bwd(k)
            ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
            idx = csr.col_idx.cpu().numpy().astype(np.int64)
            deg = np.diff(ptr)
            rows = np.full(n_out, -1, dtype=np.int64)
            one = deg == 1
            rows[one] = idx[ptr[:-1][one]]
            rows[deg > 1] = -2
            n_in_cols = index.datasets[name].n_cols
            src, dst = (x.cpu().numpy().astype(np.int64)
                        for x in op.info.attr_maps[k].pairs(n_in_cols, n_out_cols))
            cols = np.full(n_out_cols, -1, dtype=np.int64)
            seen = np.bincount(dst, minlength=n_out_cols)
            cols[dst] = src
            cols[seen > 1] = -2
            inputs.append((name, rows, cols))
        out.append((n_out, n_out_cols, inputs))
    return out


def sink_to_host(index, sink: str) -> HostTable:
    """The index's materialized sink table, as the benchmark's host table."""
    t = index.datasets[sink].table
    return HostTable(list(t.columns), t.data.cpu().numpy(), t.null.cpu().numpy())
