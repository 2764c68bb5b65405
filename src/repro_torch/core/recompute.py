"""Per-record recomputation of non-materialized intermediates (paper §III-E).

The materialization policy keeps only pipeline sources/sinks and inputs of
*contextual* operations.  A query that must RETURN data from a
non-materialized intermediate dataset re-executes, per record, the op chain
from the nearest materialized ancestor — but only on the provenance-related
rows the tensors identify, never the whole dataset.  Everything runs on
the index's device, through the port's own ops
(:mod:`repro_torch.dataprep.ops`).

* localized op: re-run its value function on exactly the gathered input rows
  (contextual ops re-apply their STORED whole-dataset statistics);
* oversample's jitter is regenerated from the stored seed (numpy's
  ``default_rng``, as capture drew it), so even synthetic rows recompute
  exactly;
* join/append outputs are assembled directly from their provenance-related
  input rows via the stored attribute permutations.

``recompute_rows(index, dataset, rows)`` returns a Table whose i-th row is
record ``rows[i]`` of ``dataset``.  An op whose tensor was spilled is
faulted back first (:meth:`~repro_torch.core.provtensor.ProvTensor.resident`):
its capture payload aliases are read here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.opcat import OpCategory
from repro_torch.core.pipeline import OpRecord, ProvenanceIndex
from repro_torch.dataprep import ops as P
from repro_torch.dataprep.table import Table

__all__ = ["materialized_frontier", "recompute_rows", "fetch_rows"]


def _row_tensor(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.asarray(list(rows), dtype=np.int64), device=device)


def materialized_frontier(index: ProvenanceIndex, dataset: str) -> str:
    """Nearest materialized ancestor of ``dataset`` (itself if materialized)."""
    cur = dataset
    while not index.datasets[cur].materialized:
        if cur not in index.producer:
            raise RuntimeError(f"{dataset}: no materialized ancestor (corrupt policy)")
        op = index.ops[index.producer[cur]]
        nxt = None
        for in_id in op.input_ids:
            if index.datasets[in_id].materialized:
                nxt = in_id
                break
        cur = nxt if nxt is not None else op.input_ids[0]
    return cur


def fetch_rows(index: ProvenanceIndex, dataset: str, rows) -> Table:
    """Rows (duplicates allowed, any order) of ``dataset``, aligned 1:1."""
    rows = _row_tensor(rows, index.device)
    uniq, inv = torch.unique(rows, return_inverse=True)
    return recompute_rows(index, dataset, uniq).take_rows(inv)


def _apply_rowwise(op: OpRecord, t: Table) -> Table:
    """Re-execute a row-local (identity-category) op on a row subset."""
    info = op.info
    name, params = info.op_name, info.params
    out = t.copy()
    if name.startswith("transform:"):
        j = t.cid(params["col"])
        out.data[:, j] = P.TRANSFORM_FNS[params["fn"]](
            t.data[:, j], params["fn_params"]).to(torch.float32)
        return out
    if name.startswith("normalize:"):
        for c, st in params["stats"].items():
            j = t.cid(c)
            if params["kind"] == "zscore":
                mu, sd = st
                out.data[:, j] = (t.data[:, j] - mu) / (sd or 1.0)
            else:
                lo, hi = st
                out.data[:, j] = (t.data[:, j] - lo) / ((hi - lo) or 1.0)
        return out
    if name.startswith("impute:"):
        for c, fill in params["fills"].items():
            j = t.cid(c)
            null = out.null[:, j]
            out.data[:, j] = torch.where(null, torch.full_like(out.data[:, j], fill),
                                         out.data[:, j])
            out.null[:, j] = False
        return out
    if name.startswith("discretize:"):
        j = t.cid(params["col"])
        edges = torch.as_tensor(params["edges"], dtype=torch.float32, device=t.device)
        out.data[:, j] = torch.searchsorted(edges, t.data[:, j].contiguous()).to(torch.float32)
        return out
    if name in ("select_columns", "drop_columns"):
        keep = (params["cols"] if name == "select_columns"
                else [c for c in t.columns if c not in set(params["cols"])])
        return t.take_cols(keep)
    if name == "onehot":
        out2, _ = P.onehot(t, params["col"], params["n_values"])
        return out2
    if name == "string_indexer":
        j = t.cid(params["col"])
        domain = torch.as_tensor(params["domain"], dtype=torch.float32, device=t.device)
        codes = torch.searchsorted(domain, t.data[:, j].contiguous()).to(torch.float32)
        return Table(
            columns=t.columns + [f"{params['col']}#idx"],
            data=torch.cat([t.data, codes[:, None]], dim=1),
            null=torch.cat([t.null, t.null[:, j: j + 1]], dim=1),
            index=t.index.clone(), vocab=dict(t.vocab),
        )
    if name == "space_transform":
        out2, _ = P.space_transform(t, params["cols"], params["proj"],
                                    params.get("prefix", "pc"))
        return out2
    raise NotImplementedError(name)


def recompute_rows(index: ProvenanceIndex, dataset: str, rows: Sequence[int]) -> Table:
    """Table whose i-th row is record rows[i] of ``dataset`` (exact values)."""
    dev = index.device
    rows = _row_tensor(rows, dev)
    rec = index.datasets[dataset]
    if rec.materialized:
        return rec.table.take_rows(rows)

    op = index.ops[index.producer[dataset]]
    op.tensor.resident()  # fault a spilled tensor back: the payload reads
    info = op.info        # below (kept_rows/src_rows/join_pairs) alias it
    cat = info.category

    if cat in (OpCategory.TRANSFORM, OpCategory.VREDUCE, OpCategory.VAUGMENT):
        sub = fetch_rows(index, op.input_ids[0], rows)
        return _apply_rowwise(op, sub)

    if cat is OpCategory.HREDUCE:
        return fetch_rows(index, op.input_ids[0], info.kept_rows.long()[rows])

    if cat is OpCategory.HAUGMENT:
        if info.src_rows is None:
            raise NotImplementedError(
                f"{info.op_name}: multi-parent augmentation has no per-row "
                "value recomputation (packed sequences are token streams)")
        src = info.src_rows.long()[rows]
        if bool((src < 0).any()):
            raise ValueError(f"{info.op_name}: rows {rows[src < 0].tolist()} are "
                             "synthetic with no established source")
        sub = fetch_rows(index, op.input_ids[0], src)
        # regenerate oversample jitter exactly from the stored seed
        if info.op_name == "oversample" and info.params.get("noise", 0) > 0:
            n_in = info.n_in[0]
            n_new = info.n_out - n_in
            rng = np.random.default_rng(info.params["seed"])
            rng.integers(0, n_in, size=n_new)          # skip the picks draw
            noise = rng.normal(0.0, info.params["noise"],
                               size=(n_new, sub.n_cols)).astype(np.float32)
            noise = torch.from_numpy(noise).to(dev)
            synth = rows >= n_in
            sub.data[synth] += noise[rows[synth] - n_in]
        return sub

    cols = list(index.datasets[dataset].columns)
    if cat is OpCategory.JOIN:
        pairs = info.join_pairs.long()[rows]
        has_l, has_r = pairs[:, 0] >= 0, pairs[:, 1] >= 0
        left = fetch_rows(index, op.input_ids[0], pairs[:, 0].clamp(min=0))
        right = fetch_rows(index, op.input_ids[1], pairs[:, 1].clamp(min=0))
        # assemble through the stored output-attr -> input-attr permutations
        perm_l = info.attr_maps[0].perm.tolist()
        perm_r = info.attr_maps[1].perm.tolist()
        n_attrs = len(perm_l)
        data = torch.zeros((len(rows), n_attrs), dtype=torch.float32, device=dev)
        null = torch.ones((len(rows), n_attrs), dtype=torch.bool, device=dev)
        # right side fills where the left did not (shared key columns keep
        # the left value on matched rows)
        right_only = has_r & ~has_l
        for a in range(n_attrs):
            if perm_l[a] >= 0:
                data[has_l, a] = left.data[has_l, perm_l[a]]
                null[has_l, a] = left.null[has_l, perm_l[a]]
            if perm_r[a] >= 0:
                use_r = right_only if perm_l[a] >= 0 else has_r
                data[use_r, a] = right.data[use_r, perm_r[a]]
                null[use_r, a] = right.null[use_r, perm_r[a]]
        vocab = {c: v for c, v in {**right.vocab, **left.vocab}.items() if c in set(cols)}
        return Table(columns=cols, data=data, null=null, index=rows.clone(), vocab=vocab)

    if cat is OpCategory.APPEND:
        n_l = info.n_in[0]
        is_l = rows < n_l
        perm_l = info.attr_maps[0].perm.tolist()
        perm_r = info.attr_maps[1].perm.tolist()
        data = torch.zeros((len(rows), len(cols)), dtype=torch.float32, device=dev)
        null = torch.ones((len(rows), len(cols)), dtype=torch.bool, device=dev)
        vocab = {}
        if bool((~is_l).any()):
            rt = fetch_rows(index, op.input_ids[1], rows[~is_l] - n_l)
            vocab.update(rt.vocab)
            for a in range(len(cols)):
                if perm_r[a] >= 0:
                    data[~is_l, a] = rt.data[:, perm_r[a]]
                    null[~is_l, a] = rt.null[:, perm_r[a]]
        if bool(is_l.any()):
            lt = fetch_rows(index, op.input_ids[0], rows[is_l])
            vocab.update(lt.vocab)
            for a in range(len(cols)):
                if perm_l[a] >= 0:
                    data[is_l, a] = lt.data[:, perm_l[a]]
                    null[is_l, a] = lt.null[:, perm_l[a]]
        vocab = {c: v for c, v in vocab.items() if c in set(cols)}
        return Table(columns=cols, data=data, null=null, index=rows.clone(), vocab=vocab)

    raise NotImplementedError(cat)
