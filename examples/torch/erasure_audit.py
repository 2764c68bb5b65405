"""GDPR erasure propagation + what-if replay over a federated catalog, on the port.

    PYTHONPATH=src python examples/torch/erasure_audit.py              # the card
    PYTHONPATH=src python examples/torch/erasure_audit.py --device cpu

The twin of ``examples/erasure_audit.py`` on ``repro_torch``, on the same
seeded data.  Two impact-analysis workloads on one closure engine:

1. **Deletion propagation** — three users revoke consent.  One
   ``erasure_plan`` over the catalog computes the full downstream closure
   (prep pipeline AND the linked serving member), lists every dataset the
   erasure touches in rebuild order, and enumerates the cached composed
   relations the rewrite poisons; ``apply_invalidations`` drops them.
2. **What-if replay** — before actually erasing, replay the sink with one
   user's income zeroed: ``whatif_replay`` recomputes ONLY the
   provenance-related sink rows (never the whole dataset) and returns
   exact before/after deltas.
"""
import argparse

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import (
    ProvCatalog,
    apply_invalidations,
    erasure_plan,
    prov,
    whatif_replay,
)

N = 500


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- prep member: a consent-bearing user pipeline --------------------------
    prep = ProvenanceIndex("prep", device=dev)
    users = Table.from_columns({
        "uid": np.arange(N, dtype=np.float32),
        "age": rng.uniform(18, 80, N).astype(np.float32),
        "income": rng.lognormal(10, 1, N).astype(np.float32),
        "score": rng.normal(size=N).astype(np.float32),
    }, device=dev)
    t = track(users, prep, "users")
    t = t.value_transform("income", "scale", factor=1e-4)
    t = t.filter_rows(t.table.col("score") > -0.5)
    t = t.oversample(frac=0.2, seed=7)
    t.mark_sink()
    clean = t.dataset_id

    # --- serving member: the prep sink crosses a boundary link -----------------
    serve = ProvenanceIndex("serve", device=dev)
    s = track(t.table, serve, "ingest")
    s = s.filter_rows(s.table.col("score") > 0.0)
    s.mark_sink()
    catalog = ProvCatalog("erasure-demo", device=dev)
    catalog.register("prep", prep).register("serve", serve)
    catalog.link(f"prep/{clean}", "serve/ingest")
    sink_ref = f"serve/{s.dataset_id}"

    # warm the caches an erasure would poison: a lineage probe composes
    # per-member relations the usual way
    prov(catalog).source("prep/users").rows([0]).forward().to(sink_ref).run()
    prep.composed().relation("users", clean)

    # --- 1. deletion propagation -----------------------------------------------
    revoked = sorted(rng.choice(N, size=3, replace=False).tolist())
    plan = erasure_plan(catalog, "prep/users", revoked)
    print(f"consent revoked by users {revoked}\n")
    print(plan.describe())
    print(f"\nrebuild order: {list(plan.rebuild)}")
    dropped = apply_invalidations(catalog, plan)
    print(f"stale cached relations dropped: {dropped}")
    if prep.composed().stats()["entries"] != 0:
        raise SystemExit("the erasure left composed relations cached")

    # --- 2. what-if replay -------------------------------------------------------
    res = whatif_replay(serve, "ingest", [0], {"income": [0.0]}, s.dataset_id)
    print(f"\nwhat-if: zero ingest row 0's income -> {len(res.sink_rows)} of "
          f"{serve.datasets[s.dataset_id].n_rows} sink rows recomputed")
    for row, delta in zip(res.sink_rows.tolist(), res.row_deltas()):
        for col, (lo, hi) in delta.items():
            print(f"  sink row {row}: {col} {lo:.4f} -> {hi:.4f}")
    if not (bool(res.changed.any()) or len(res.sink_rows) == 0):
        raise SystemExit("the what-if replay changed nothing")
    if serve.datasets["ingest"].table.data is None:      # recorded provenance untouched
        raise SystemExit("the replay dropped the recorded ingest table")
    print("\nerasure planned, caches invalidated, what-if replayed — "
          "without rerunning the pipeline.")


if __name__ == "__main__":
    main()
