"""The data-preparation operations of paper Table I, with capture payloads.

Every public op returns ``(out_table, CaptureInfo)`` and runs on the
input table's device; the capture payload (kept rows, source rows, join
pairs) is int32 on that device.

Two things are computed on the host on purpose, so that the port picks the
same rows and bins as ``repro``: the random draws of ``undersample`` and
``oversample`` (numpy ``default_rng(seed)``, then moved to the device; a
``torch.Generator`` would pick other rows), and the few quantile edges of
``discretize`` (numpy's linear-interpolation formula in float64 over order
statistics taken on the device).  Float reductions (means, standard
deviations) sum in another order than numpy's, so float values agree to
float32 rounding, while every provenance payload agrees exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
from repro_torch.core.schema import Bitset
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.dataprep.table import Table
from repro_torch.kernels.ops import join_gather, join_match

__all__ = [
    "value_transform",
    "binarize",
    "normalize",
    "impute",
    "discretize",
    "select_columns",
    "drop_columns",
    "filter_rows",
    "undersample",
    "onehot",
    "string_indexer",
    "space_transform",
    "oversample",
    "join",
    "append",
    "TRANSFORM_FNS",
]

OpResult = Tuple[Table, CaptureInfo]


def _on(x, t: Table, dtype: torch.dtype) -> torch.Tensor:
    """A host array or a tensor -> ``dtype`` on the table's device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        count_host_copy(t.device)
    return x.to(device=t.device, dtype=dtype)


# ---------------------------------------------------------------------------
# Data transformation (identity tensor; identity attr map)
# ---------------------------------------------------------------------------
TRANSFORM_FNS = {
    "log1p": lambda x, p: torch.log1p(torch.clamp(x, min=0.0)),
    "scale": lambda x, p: x * p.get("factor", 1.0) + p.get("offset", 0.0),
    "clip": lambda x, p: torch.clamp(x, p.get("lo", -float("inf")), p.get("hi", float("inf"))),
    "binarize": lambda x, p: (x > p["threshold"]).to(torch.float32),
}


def value_transform(t: Table, col: str, fn: str, **fn_params) -> OpResult:
    """Localized TRANSFORM: y = f(x) per cell."""
    out = t.copy()
    j = t.cid(col)
    out.data[:, j] = TRANSFORM_FNS[fn](t.data[:, j], fn_params).to(torch.float32)
    info = CaptureInfo(
        op_name=f"transform:{fn}",
        category=OpCategory.TRANSFORM,
        contextual=False,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="identity")],
        params={"col": col, "fn": fn, "fn_params": fn_params},
    )
    return out, info


def binarize(t: Table, col: str, threshold: float) -> OpResult:
    return value_transform(t, col, "binarize", threshold=threshold)


def normalize(t: Table, cols: Sequence[str], kind: str = "zscore") -> OpResult:
    """Contextual TRANSFORM: needs whole-column statistics (paper §III-E)."""
    out = t.copy()
    stats = {}
    for c in cols:
        j = t.cid(c)
        x = t.data[:, j]
        v = x[~t.null[:, j]]
        # the boolean index, and the two statistics read on the host
        count(HOST_SYNCS, 3 if v.numel() else 1)
        if kind == "zscore":
            mu = float(v.mean()) if v.numel() else 0.0
            sd = float(v.std(correction=0)) if v.numel() else float("nan")
            sd = sd or 1.0
            out.data[:, j] = (x - mu) / sd
            stats[c] = (mu, sd)
        elif kind == "minmax":
            lo = float(v.min()) if v.numel() else 0.0
            hi = float(v.max()) if v.numel() else 1.0
            out.data[:, j] = (x - lo) / ((hi - lo) or 1.0)
            stats[c] = (lo, hi)
        else:
            raise ValueError(kind)
    info = CaptureInfo(
        op_name=f"normalize:{kind}",
        category=OpCategory.TRANSFORM,
        contextual=True,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="identity")],
        params={"cols": list(cols), "kind": kind, "stats": stats},
    )
    return out, info


def _median(v: torch.Tensor) -> float:
    """numpy's median: the middle value, or the float32 mean of the two
    middle values of an even count."""
    s = torch.sort(v).values
    m = s.numel() // 2
    count(HOST_SYNCS)
    if s.numel() % 2:
        return float(s[m])
    return float((s[m - 1] + s[m]) / 2)


def _mode(v: torch.Tensor) -> float:
    """numpy's ``unique`` + ``argmax`` mode: the smallest most frequent value."""
    vals, counts = torch.unique(v, sorted=True, return_counts=True)
    count(HOST_SYNCS, 2)
    return float(vals[torch.argmax(counts)])


def impute(t: Table, cols: Sequence[str], strategy: str = "mean") -> OpResult:
    """Contextual TRANSFORM: fill nulls from whole-column statistics."""
    out = t.copy()
    fills = {}
    for c in cols:
        j = t.cid(c)
        x = t.data[:, j]
        valid = ~t.null[:, j]
        count(HOST_SYNCS)
        v = x[valid]
        if strategy == "mean":
            count(HOST_SYNCS, 1 if v.numel() else 0)
            fill = float(v.mean()) if v.numel() else 0.0
        elif strategy == "median":
            fill = _median(v) if v.numel() else 0.0
        elif strategy == "mode":
            fill = _mode(v) if v.numel() else 0.0
        else:
            raise ValueError(strategy)
        out.data[:, j] = torch.where(valid, x, torch.full_like(x, fill))
        out.null[:, j] = False
        fills[c] = fill
    info = CaptureInfo(
        op_name=f"impute:{strategy}",
        category=OpCategory.TRANSFORM,
        contextual=True,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="identity")],
        params={"cols": list(cols), "strategy": strategy, "fills": fills},
    )
    return out, info


def _quantile_edges(x: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """``np.quantile(x, qs)`` (linear method, float64 result): the order
    statistics come from one sort on the device, the interpolation runs on
    the host with numpy's own formula."""
    n = x.numel()
    count(HOST_SYNCS)
    if bool(torch.isnan(x).any()):
        return np.full(len(qs), np.nan)
    virtual = (n - 1) * qs
    prev = np.floor(virtual).astype(np.int64)
    nxt = prev + 1
    above = virtual >= n - 1
    prev[above] = n - 1
    nxt[above] = n - 1
    gamma = virtual - np.floor(virtual)
    picks = torch.as_tensor(np.concatenate([prev, nxt]), device=x.device)
    count_host_copy(x.device)
    count(HOST_SYNCS)
    order = torch.sort(x).values[picks].cpu().numpy()      # float32
    a, b = order[: len(qs)], order[len(qs):]
    diff = (b - a).astype(np.float64)                       # float32 difference
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)


def discretize(t: Table, col: str, n_bins: int, kind: str = "uniform") -> OpResult:
    """TRANSFORM; the bin edges come from the data, so it is contextual."""
    out = t.copy()
    j = t.cid(col)
    x = t.data[:, j]
    if kind == "uniform":
        count(HOST_SYNCS, 2)
        lo, hi = float(x.min()), float(x.max())
        edges = np.linspace(lo, hi, n_bins + 1)[1:-1]
    elif kind == "quantile":
        edges = _quantile_edges(x, np.linspace(0, 1, n_bins + 1)[1:-1])
    else:
        raise ValueError(kind)
    count_host_copy(t.device)
    edges_t = torch.as_tensor(edges, dtype=torch.float64, device=t.device)
    out.data[:, j] = torch.searchsorted(edges_t, x.to(torch.float64)).to(torch.float32)
    info = CaptureInfo(
        op_name=f"discretize:{kind}",
        category=OpCategory.TRANSFORM,
        contextual=True,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="identity")],
        params={"col": col, "edges": edges.tolist(), "kind": kind},
    )
    return out, info


# ---------------------------------------------------------------------------
# Vertical reduction (identity tensor; bitset attr map — paper Table VI)
# ---------------------------------------------------------------------------
def select_columns(t: Table, cols: Sequence[str]) -> OpResult:
    """Keep ``cols`` in their original relative order (bitset annotation) or
    arbitrary order (the paper's permutation-list annotation)."""
    keep_ids = [t.cid(c) for c in cols]
    order_preserved = keep_ids == sorted(keep_ids)
    out = t.take_cols(cols)
    amap = AttrMap(kind="vreduce", bitset=Bitset.from_indices(keep_ids, t.n_cols))
    if not order_preserved:
        amap.perm = torch.as_tensor(keep_ids, dtype=torch.int32)
    info = CaptureInfo(
        op_name="select_columns",
        category=OpCategory.VREDUCE,
        contextual=False,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[amap],
        params={"cols": list(cols)},
    )
    return out, info


def drop_columns(t: Table, cols: Sequence[str]) -> OpResult:
    keep = [c for c in t.columns if c not in set(cols)]
    out, info = select_columns(t, keep)
    info.op_name = "drop_columns"
    info.params = {"cols": list(cols)}
    return out, info


# ---------------------------------------------------------------------------
# Horizontal reduction (masking tensor; identity attr map)
# ---------------------------------------------------------------------------
def filter_rows(t: Table, mask, op_name: str = "filter") -> OpResult:
    """Observation-based capture via preserved dataframe indices (§III-B)."""
    mask = _on(mask, t, torch.bool)
    count(HOST_SYNCS)
    kept = torch.nonzero(mask).reshape(-1)
    out = t.take_rows(kept, keep_index=True)
    info = CaptureInfo(
        op_name=op_name,
        category=OpCategory.HREDUCE,
        contextual=False,
        n_out=len(kept),
        n_in=[t.n_rows],
        kept_rows=kept.to(torch.int32),
        attr_maps=[AttrMap(kind="identity")],
        params={},
    )
    return out, info


def undersample(t: Table, frac: float, seed: int = 0) -> OpResult:
    rng = np.random.default_rng(seed)
    kept = np.sort(rng.choice(t.n_rows, size=max(1, int(t.n_rows * frac)), replace=False))
    mask = torch.zeros(t.n_rows, dtype=torch.bool, device=t.device)
    mask[_on(kept, t, torch.int64)] = True
    count_host_copy(t.device)
    out, info = filter_rows(t, mask, op_name="undersample")
    info.params = {"frac": frac, "seed": seed}
    return out, info


# ---------------------------------------------------------------------------
# Vertical augmentation (identity tensor; bitset attr map — paper Table VI)
# ---------------------------------------------------------------------------
def onehot(t: Table, col: str, n_values: Optional[int] = None) -> OpResult:
    j = t.cid(col)
    x = t.data[:, j].to(torch.int64)
    contextual = n_values is None
    if n_values is None and len(x):
        count(HOST_SYNCS)
        n_values = int(x.max()) + 1
    elif n_values is None:
        n_values = 1
    eye = torch.zeros((t.n_rows, n_values), dtype=torch.float32, device=t.device)
    valid = (x >= 0) & (x < n_values) & ~t.null[:, j]
    count(HOST_SYNCS)
    rows = torch.nonzero(valid).reshape(-1)
    eye[rows, x[rows]] = 1.0
    count_host_copy(t.device)
    out = Table(
        columns=t.columns + [f"{col}={v}" for v in range(n_values)],
        data=torch.cat([t.data, eye], dim=1),
        null=torch.cat([t.null, torch.zeros_like(eye, dtype=torch.bool)], dim=1),
        index=t.index.clone(),
        vocab=dict(t.vocab),
    )
    m = t.n_cols
    # paper's single-bitset encoding: source input attrs ∪ new output attrs
    bits = Bitset.from_indices([j] + list(range(m, m + n_values)), m + n_values)
    info = CaptureInfo(
        op_name="onehot",
        category=OpCategory.VAUGMENT,
        contextual=contextual,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="vaugment", bitset=bits, m=m)],
        params={"col": col, "n_values": n_values},
    )
    return out, info


def string_indexer(t: Table, col: str) -> OpResult:
    """Adds ``col#idx`` = dense rank of the value (contextual: needs domain)."""
    j = t.cid(col)
    x = t.data[:, j]
    count(HOST_SYNCS, 3)        # the boolean index, the unique, the domain's read
    vals = torch.unique(x[~t.null[:, j]], sorted=True)
    codes = torch.searchsorted(vals, x.contiguous()).to(torch.float32)
    out = Table(
        columns=t.columns + [f"{col}#idx"],
        data=torch.cat([t.data, codes[:, None]], dim=1),
        null=torch.cat([t.null, t.null[:, j: j + 1]], dim=1),
        index=t.index.clone(),
        vocab=dict(t.vocab),
    )
    m = t.n_cols
    info = CaptureInfo(
        op_name="string_indexer",
        category=OpCategory.VAUGMENT,
        contextual=True,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="vaugment", bitset=Bitset.from_indices([j, m], m + 1), m=m)],
        params={"col": col, "domain": vals.tolist()},
    )
    return out, info


def space_transform(t: Table, cols: Sequence[str], proj, prefix: str = "pc") -> OpResult:
    """Linear feature map (PCA-style) onto ``proj.shape[1]`` new attributes."""
    ids = [t.cid(c) for c in cols]
    proj = _on(proj, t, torch.float32)
    count_host_copy(t.device)   # the column list
    newvals = t.data[:, ids] @ proj
    names = [f"{prefix}{i}" for i in range(proj.shape[1])]
    out = Table(
        columns=t.columns + names,
        data=torch.cat([t.data, newvals], dim=1),
        null=torch.cat([t.null, torch.zeros_like(newvals, dtype=torch.bool)], dim=1),
        index=t.index.clone(),
        vocab=dict(t.vocab),
    )
    m = t.n_cols
    bits = Bitset.from_indices(ids + list(range(m, m + proj.shape[1])), m + proj.shape[1])
    info = CaptureInfo(
        op_name="space_transform",
        category=OpCategory.VAUGMENT,
        contextual=False,
        n_out=t.n_rows,
        n_in=[t.n_rows],
        attr_maps=[AttrMap(kind="vaugment", bitset=bits, m=m)],
        params={"cols": list(cols), "proj": proj},
    )
    return out, info


# ---------------------------------------------------------------------------
# Horizontal augmentation (src-mapped tensor; identity attr map)
# ---------------------------------------------------------------------------
def oversample(t: Table, frac: float, seed: int = 0, noise: float = 0.0) -> OpResult:
    """Appends ``frac * n`` duplicated (optionally jittered) rows; the
    output -> source correspondence is kept (paper §III-A e)."""
    rng = np.random.default_rng(seed)
    n_new = max(1, int(t.n_rows * frac))
    picks = _on(rng.integers(0, t.n_rows, size=n_new), t, torch.int64)
    new_data = t.data[picks].clone()
    if noise > 0:
        new_data += _on(rng.normal(0.0, noise, size=tuple(new_data.shape)).astype(np.float32),
                        t, torch.float32)
    fresh = torch.arange(n_new, dtype=torch.int64, device=t.device)
    out = Table(
        columns=list(t.columns),
        data=torch.cat([t.data, new_data], dim=0),
        null=torch.cat([t.null, t.null[picks]], dim=0),
        index=torch.cat([t.index, t.index.max() + 1 + fresh]),
        vocab=dict(t.vocab),
    )
    src = torch.cat([torch.arange(t.n_rows, dtype=torch.int32, device=t.device),
                     picks.to(torch.int32)])
    info = CaptureInfo(
        op_name="oversample",
        category=OpCategory.HAUGMENT,
        contextual=False,
        n_out=out.n_rows,
        n_in=[t.n_rows],
        src_rows=src,
        attr_maps=[AttrMap(kind="identity")],
        params={"frac": frac, "seed": seed, "noise": noise},
    )
    return out, info


# ---------------------------------------------------------------------------
# Join (order-3 tensor; two bitsets + permutation lists — paper Table VI)
# ---------------------------------------------------------------------------
def join(left: Table, right: Table, on: str, how: str = "inner",
         max_pairs: Optional[int] = None) -> OpResult:
    """Sort-merge equi-join with Pandas-merge bag semantics.

    ACTIVE capture (paper §III-B / §V): the match runs over row ids threaded
    through a stable sort of the right keys, so the (left_row, right_row)
    pairs ARE the provenance.  Pair order is ``repro``'s: matches by left
    row, then by right key order; then left dangles; then right dangles.
    Keys compare in numpy's order: a NaN key matches every NaN key, and
    ``-0.0`` matches ``0.0``.
    """
    if left.device != right.device:
        raise ValueError(f"join inputs lie on {left.device} and {right.device}")
    dev = left.device
    lk = left.col(on).contiguous()
    # one NaN for all: the card's radix sort puts a NaN with its sign bit
    # set first, numpy every NaN last
    r_sorted = torch.sort(torch.nan_to_num(right.col(on), nan=float("nan"), posinf=float("inf"),
                                           neginf=float("-inf")), stable=True)
    # the match reads its total once
    count(HOST_SYNCS)
    counts, _, matched = join_match(lk, r_sorted.values, r_sorted.indices)

    pairs = [matched]
    if how in ("left", "outer"):
        count(HOST_SYNCS)
        dangling_l = torch.nonzero(counts == 0).reshape(-1).to(torch.int32)
        pairs.append(torch.stack([dangling_l, torch.full_like(dangling_l, -1)], dim=1))
    if how in ("right", "outer"):
        matched_r = torch.zeros(right.n_rows, dtype=torch.bool, device=dev)
        matched_r[matched[:, 1]] = True
        count_host_copy(dev)
        count(HOST_SYNCS)
        dangling_r = torch.nonzero(~matched_r).reshape(-1).to(torch.int32)
        pairs.append(torch.stack([torch.full_like(dangling_r, -1), dangling_r], dim=1))
    join_pairs = torch.cat(pairs, dim=0) if len(pairs) > 1 else pairs[0]
    if max_pairs is not None and len(join_pairs) > max_pairs:
        join_pairs = join_pairs[:max_pairs].clone()

    # assemble output: key, left non-key cols, right non-key cols
    l_cols = [c for c in left.columns if c != on]
    r_cols = [c for c in right.columns if c != on]
    out_names = [on] + [f"{c}_l" if c in r_cols else c for c in l_cols] \
        + [f"{c}_r" if c in l_cols else c for c in r_cols]
    n_out_attrs = 1 + len(l_cols) + len(r_cols)
    lj = [left.cid(c) for c in l_cols]
    rj = [right.cid(c) for c in r_cols]
    lkey, rkey = left.cid(on), right.cid(on)
    data, null = join_gather(left.data.contiguous(), left.null.contiguous(),
                             right.data.contiguous(), right.null.contiguous(),
                             join_pairs, lkey, rkey)
    n_out = len(join_pairs)
    out = Table(
        columns=out_names,
        data=data,
        null=null,
        index=torch.arange(n_out, dtype=torch.int64, device=dev),
        vocab={**right.vocab, **left.vocab},
    )

    # paper Table VI: one bitset per input over OUTPUT attr positions
    bits_l = Bitset.from_indices([0] + list(range(1, 1 + len(l_cols))), n_out_attrs)
    bits_r = Bitset.from_indices([0] + list(range(1 + len(l_cols), n_out_attrs)), n_out_attrs)
    # explicit permutation lists (order-changing fallback): out attr -> in attr
    perm_l = torch.full((n_out_attrs,), -1, dtype=torch.int32)
    perm_l[0] = lkey
    perm_l[1: 1 + len(l_cols)] = torch.as_tensor(lj, dtype=torch.int32)
    perm_r = torch.full((n_out_attrs,), -1, dtype=torch.int32)
    perm_r[0] = rkey
    perm_r[1 + len(l_cols):] = torch.as_tensor(rj, dtype=torch.int32)

    info = CaptureInfo(
        op_name=f"join:{how}",
        category=OpCategory.JOIN,
        contextual=False,
        n_out=n_out,
        n_in=[left.n_rows, right.n_rows],
        join_pairs=join_pairs,
        attr_maps=[
            AttrMap(kind="join", bitset=bits_l, perm=perm_l),
            AttrMap(kind="join", bitset=bits_r, perm=perm_r),
        ],
        params={"on": on, "how": how},
    )
    return out, info


# ---------------------------------------------------------------------------
# Append (two block-diagonal tensors; two bitsets — paper §III-A g)
# ---------------------------------------------------------------------------
def append(left: Table, right: Table) -> OpResult:
    """Outer-union: result schema = left cols ∪ right cols, null-extended."""
    if left.device != right.device:
        raise ValueError(f"append inputs lie on {left.device} and {right.device}")
    out_names = list(left.columns) + [c for c in right.columns if c not in left.columns]
    n_out = left.n_rows + right.n_rows
    data = torch.zeros((n_out, len(out_names)), dtype=torch.float32, device=left.device)
    null = torch.ones((n_out, len(out_names)), dtype=torch.bool, device=left.device)
    perm_l = torch.full((len(out_names),), -1, dtype=torch.int32)
    perm_r = torch.full((len(out_names),), -1, dtype=torch.int32)
    for a, c in enumerate(out_names):
        if c in left.columns:
            data[: left.n_rows, a] = left.col(c)
            null[: left.n_rows, a] = left.col_null(c)
            perm_l[a] = left.cid(c)
        if c in right.columns:
            data[left.n_rows:, a] = right.col(c)
            null[left.n_rows:, a] = right.col_null(c)
            perm_r[a] = right.cid(c)
    out = Table(
        columns=out_names,
        data=data,
        null=null,
        index=torch.arange(n_out, dtype=torch.int64, device=left.device),
        vocab={**right.vocab, **left.vocab},
    )
    info = CaptureInfo(
        op_name="append",
        category=OpCategory.APPEND,
        contextual=False,
        n_out=n_out,
        n_in=[left.n_rows, right.n_rows],
        attr_maps=[
            AttrMap(kind="join", bitset=Bitset.from_bits(perm_l >= 0), perm=perm_l),
            AttrMap(kind="join", bitset=Bitset.from_bits(perm_r >= 0), perm=perm_r),
        ],
        params={},
    )
    return out, info
