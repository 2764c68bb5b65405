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
* a join's rows are assembled by capture's own kernel,
  :func:`repro_torch.kernels.ops.join_gather`, from the selected row pairs:
  a materialized input goes to it whole with the pairs as they are, a
  non-materialized one is recomputed once on its distinct rows and its
  side of the pairs remapped onto them;
* append outputs are assembled from their input rows via the stored
  attribute permutations.

``recompute_rows(index, dataset, rows)`` returns a Table whose i-th row is
record ``rows[i]`` of ``dataset``.  An op whose tensor was spilled is
faulted back first (:meth:`~repro_torch.core.provtensor.ProvTensor.resident`):
its capture payload aliases are read here.

Counted while a :func:`~repro_torch.core.spans.recording` is open:
:data:`RECOMPUTE_OPS` once an op re-executed, :data:`RECOMPUTE_ROWS` the
rows it re-executed on, and :data:`~repro_torch.core.spans.HOST_SYNCS` at
every read of the device (a ``unique``, a ``nonzero``, a ``bool()``) and
every copy from the host.  A materialized dataset's rows are a gather,
which reads nothing.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opcat import OpCategory
from repro_torch.core.pipeline import OpRecord, ProvenanceIndex
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.dataprep import ops as P
from repro_torch.dataprep.table import Table
from repro_torch.kernels.ops import join_gather

__all__ = ["RECOMPUTE_OPS", "RECOMPUTE_ROWS", "materialized_frontier", "recompute_rows",
           "fetch_rows"]

RECOMPUTE_OPS = "recompute_ops"      # ops re-executed
RECOMPUTE_ROWS = "recompute_rows"    # the rows they re-executed on


def _row_tensor(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int64).reshape(-1)
    count_host_copy(device)
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
    """Rows (duplicates allowed, any order) of ``dataset``, aligned 1:1: a
    gather of a materialized dataset (``recompute_rows``, with no
    ``unique``), else a recomputation of the distinct rows (one ``unique``)
    gathered back into ``rows``' order."""
    rows = _row_tensor(rows, index.device)
    if index.datasets[dataset].materialized:
        return recompute_rows(index, dataset, rows)
    count(HOST_SYNCS)
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
        count_host_copy(t.device)
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
        count_host_copy(t.device)
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


def _join_keys(op: OpRecord, n_left: int, n_right: int) -> Tuple[int, int]:
    """The join's key columns, after checking that its stored permutations
    are ``ops.join``'s layout, the one ``join_gather`` writes: the key,
    then the left's other columns in order, then the right's."""
    # the permutations are host tensors: reading them waits for no device
    perm_l = op.info.attr_maps[0].perm.numpy().tolist()
    perm_r = op.info.attr_maps[1].perm.numpy().tolist()
    lkey, rkey = perm_l[0], perm_r[0]
    want_l = [lkey] + [j for j in range(n_left) if j != lkey] + [-1] * (n_right - 1)
    want_r = [rkey] + [-1] * (n_left - 1) + [j for j in range(n_right) if j != rkey]
    if perm_l != want_l or perm_r != want_r:
        raise ValueError(f"{op.info.op_name}: attribute permutations {perm_l}, {perm_r} are "
                         "not a captured join's layout (key, left columns, right columns)")
    return lkey, rkey


def _join_side(index: ProvenanceIndex, dataset: str, side: torch.Tensor):
    """(table, row of it for each pair) for one input of a join: a
    materialized input whole with its side of the pairs; else its distinct
    rows recomputed (one ``unique``) and the side remapped onto them, -1
    kept."""
    rec = index.datasets[dataset]
    if rec.materialized:
        return rec.table, side
    count(HOST_SYNCS)
    uniq, inv = torch.unique(side.clamp(min=0), return_inverse=True)
    return (recompute_rows(index, dataset, uniq),
            torch.where(side >= 0, inv.to(torch.int32), -1))


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
    count(RECOMPUTE_OPS)
    count(RECOMPUTE_ROWS, len(rows))

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
        count(HOST_SYNCS)
        if bool((src < 0).any()):
            raise ValueError(f"{info.op_name}: rows {rows[src < 0].tolist()} are "
                             "synthetic with no established source")
        sub = fetch_rows(index, op.input_ids[0], src)
        # regenerate oversample jitter exactly from the stored seed
        n_in = info.n_in[0]
        n_new = info.n_out - n_in
        if info.op_name == "oversample" and info.params.get("noise", 0) > 0 and n_new > 0:
            rng = np.random.default_rng(info.params["seed"])
            rng.integers(0, n_in, size=n_new)          # skip the picks draw
            noise = rng.normal(0.0, info.params["noise"],
                               size=(n_new, sub.n_cols)).astype(np.float32)
            count_host_copy(dev)
            noise = torch.from_numpy(noise).to(dev)
            synth = (rows >= n_in)[:, None]
            jitter = noise[(rows - n_in).clamp(min=0, max=n_new - 1)]
            sub.data = torch.where(synth, sub.data + jitter, sub.data)
        return sub

    cols = list(index.datasets[dataset].columns)
    if cat is OpCategory.JOIN:
        pairs = info.join_pairs[rows].to(torch.int32)
        (left, lp), (right, rp) = (_join_side(index, d, pairs[:, k])
                                   for k, d in enumerate(op.input_ids))
        lkey, rkey = _join_keys(op, left.n_cols, right.n_cols)
        data, null = join_gather(left.data.contiguous(), left.null.contiguous(),
                                 right.data.contiguous(), right.null.contiguous(),
                                 torch.stack([lp, rp], dim=1), lkey, rkey)
        vocab = {c: v for c, v in {**right.vocab, **left.vocab}.items() if c in set(cols)}
        return Table(columns=cols, data=data, null=null, index=rows.clone(), vocab=vocab)

    if cat is OpCategory.APPEND:
        n_l = info.n_in[0]
        is_l = rows < n_l
        data = torch.zeros((len(rows), len(cols)), dtype=torch.float32, device=dev)
        null = torch.ones((len(rows), len(cols)), dtype=torch.bool, device=dev)
        vocab = {}
        # the right input's rows, then the left's, each written through its
        # stored output-attr -> input-attr permutation
        for k, at, offset in ((1, ~is_l, n_l), (0, is_l, 0)):
            count(HOST_SYNCS)
            at = torch.nonzero(at).reshape(-1)
            if not len(at):
                continue
            part = fetch_rows(index, op.input_ids[k], rows[at] - offset)
            vocab.update(part.vocab)
            perm = info.attr_maps[k].perm.numpy().tolist()
            out_cols = [a for a, p in enumerate(perm) if p >= 0]
            count_host_copy(dev, 2)
            out_at = torch.as_tensor(out_cols, dtype=torch.int64, device=dev)
            in_at = torch.as_tensor([perm[a] for a in out_cols], dtype=torch.int64, device=dev)
            data[at[:, None], out_at] = part.data[:, in_at]
            null[at[:, None], out_at] = part.null[:, in_at]
        vocab = {c: v for c, v in vocab.items() if c in set(cols)}
        return Table(columns=cols, data=data, null=null, index=rows.clone(), vocab=vocab)

    raise NotImplementedError(cat)
