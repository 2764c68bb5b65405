"""The port's twins of ``pipegen``'s and ``test_compose``'s pipelines, free
of JAX so that the spawned ranks of the multi-process tests can build them
(each rank builds the same index from the same seed).

* :func:`random_pipeline` — ``pipegen.random_pipeline`` (same rng draws,
  same ops);
* :func:`compose_pipeline` — ``tests/test_compose.py``'s ``_pipeline``.
"""
import numpy as np
import torch

from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track

CPU = "cpu"


def random_pipeline(seed, name="parity"):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(15, 50))
    K = max(3, n // 4)
    idx = ProvenanceIndex(f"{name}{seed}", device=CPU)
    t = Table.from_columns({
        "k": rng.integers(0, K, n).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32),
        "g": rng.integers(0, 4, n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
    }, device=CPU)
    cur = track(t, idx, "src")
    for i in range(int(rng.integers(3, 8))):
        code = int(rng.integers(0, 9))
        cols = cur.table.columns
        if code == 0:
            mask = cur.table.col("x").numpy() > float(rng.normal(-1.0, 0.4))
            if not mask.any():
                mask[0] = True
            cur = cur.filter_rows(torch.from_numpy(mask))
        elif code == 1:
            cur = cur.value_transform("x", "scale", factor=2.0)
        elif code == 2:
            cur = cur.oversample(frac=0.3, seed=int(rng.integers(1 << 20)))
        elif code == 3:
            cur = cur.undersample(frac=0.7, seed=int(rng.integers(1 << 20)))
        elif code == 4 and "g" in cols:
            cur = cur.onehot("g", n_values=4)
        elif code == 5:
            keep = [c for c in cols if c in ("k", "x", "g")]
            extra = [c for c in cols if c not in ("k", "x", "g")]
            rng.shuffle(keep)
            keep += [str(c) for c in rng.choice(extra, size=len(extra) // 2, replace=False)] \
                if extra else []
            cur = cur.select_columns(keep)
        elif code == 6:
            r = Table.from_columns({
                "k": np.arange(K, dtype=np.float32),
                f"z{i}": rng.normal(size=K).astype(np.float32),
            }, device=CPU)
            how = str(rng.choice(["inner", "outer"]))
            cur = cur.join(track(r, idx), on="k", how=how)
        elif code == 7:
            m = int(rng.integers(3, 9))
            r = Table.from_columns({
                "x": rng.normal(size=m).astype(np.float32),
                f"w{i}": rng.normal(size=m).astype(np.float32),
            }, device=CPU)
            cur = cur.append(track(r, idx))
        elif code == 8 and "y" in cols:
            cur = cur.drop_columns(["y"])
        if cur.table.n_rows == 0:
            break
    cur.mark_sink()
    return idx, cur.dataset_id, rng


def compose_pipeline(seed=0, n=64, device=CPU):
    """src (n rows) joined with ref, filtered, scaled, oversampled: returns
    (index, the filter's output id, the sink id)."""
    rng = np.random.default_rng(seed)
    idx = ProvenanceIndex("c", device=device)
    t = Table.from_columns({
        "k": rng.integers(0, n // 2, n).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32),
        "g": rng.integers(0, 2, n).astype(np.float32),
    }, device=device)
    r = Table.from_columns({
        "k": np.arange(n // 2, dtype=np.float32),
        "y": rng.normal(size=n // 2).astype(np.float32),
    }, device=device)
    tt, tr = track(t, idx, "src"), track(r, idx, "ref")
    tj = tt.join(tr, on="k", how="inner")
    tf = tj.filter_rows(tj.table.col("x") > -0.5)
    tv = tf.value_transform("x", "scale", factor=2.0)
    to = tv.oversample(frac=0.3, seed=seed).mark_sink()
    return idx, tf.dataset_id, to.dataset_id
