"""Federated lineage: prep pipeline -> boundary export -> serving -> raw row, on the port.

    PYTHONPATH=src python examples/torch/federated_lineage.py              # the card
    PYTHONPATH=src python examples/torch/federated_lineage.py --device cpu

The twin of ``examples/federated_lineage.py`` on ``repro_torch``, on the
same seeded pipeline and requests (the model's weights are random and
differ from the original's, so the tokens do; the lineage does not).  A
data-preparation pipeline owns its :class:`ProvenanceIndex`; the serving
tier owns ANOTHER.  The prep side exports a read-only
:class:`BoundaryHandle` over its clean output — never the index itself —
and the engine attaches it with ``upstream=``.  Each recorded request batch
links to boundary rows through the ``request_ids`` alignment, so
``response_lineage`` traces a generated response all the way back to the
RAW source row across the index boundary: one plan, split at the boundary,
one cost-model-routed pass per side.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.models.registry import get_model
from repro_torch.provenance import CapabilityError, prov
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- the data-prep pipeline, in ITS OWN index -----------------------------
    rng = np.random.default_rng(7)
    n_users = 16
    raw = Table.from_columns({
        "user_id": np.arange(100, 100 + n_users, dtype=np.float32),
        "age": rng.integers(12, 70, n_users).astype(np.float32),
        "score": rng.normal(size=n_users).astype(np.float32),
    }, device=dev)
    prep = ProvenanceIndex("prep", device=dev)
    t = track(raw, prep, "raw_users")
    t = t.filter_rows(t.table.col("age") >= 18.0)   # drop minors
    t = t.value_transform("score", "scale", factor=0.5)
    clean = t.mark_sink()
    print(f"prep pipeline: raw_users ({n_users} rows) -> {clean.dataset_id} "
          f"({clean.table.n_rows} rows), {len(prep.ops)} ops")

    # --- export the boundary: a read-only capability, NOT the index -----------
    handle = prep.export(clean.dataset_id)
    print("exported boundary:", handle)
    try:
        handle.record([], "nope", None, None)
    except CapabilityError:
        print("capability: prep index is read-only from the serving tier")

    # --- the serving tier attaches upstream provenance via the handle ---------
    cfg = get_smoke_config("gemma3-1b")
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    B, SP, NEW = 4, 8, 6
    prompts = rng.integers(1, cfg.vocab, (B, SP)).astype(np.int32)
    engine = ServeEngine(cfg, params, max_seq=SP + NEW, dtype=torch.float32, device=dev,
                         upstream=handle)

    # each request serves a row of the CLEAN dataset: request_ids are the row
    # alignment across the boundary link
    request_rows = np.array([0, 3, 3, 5]) % clean.table.n_rows
    result = engine.generate(prompts, n_new=NEW, request_ids=request_rows,
                             record_provenance=True)
    print("recorded:", result.request_dataset, "->", result.response_dataset,
          "| catalog:", engine.catalog)

    # --- trace one response token back to the raw source row ------------------
    src_row = engine.response_lineage(result, rows=[2], upstream="raw_users")
    uid = int(raw.col("user_id")[src_row[0]])
    print(f"response row 2 traces to raw user row {src_row.tolist()} "
          f"(user_id {uid}) across the boundary")

    # batched: every response row traced in ONE pass per federation side
    per_request = engine.response_lineage_batch(
        result, [[i] for i in range(B)], upstream="prep/raw_users")
    print("batch trace-to-source:", {i: r.tolist() for i, r in enumerate(per_request)})

    # --- the plan split is inspectable -----------------------------------------
    plan = (prov(engine.catalog)
            .source(f"serve/{result.response_dataset}").rows([2])
            .backward().to("prep/raw_users").plan())
    ex = engine.federation.explain(plan)
    print("explain: strategy", ex["strategy"], "| segments:",
          [(s["index"], s["segment"], s["strategy"]) for s in ex["segments"]],
          "| links:", ex["links"])
    st = engine.federation.stats()
    print("federation stats:", st["federation"])
    print("per-index planner plans:",
          {name: s["planner"]["plans"] for name, s in st["indexes"].items()})


if __name__ == "__main__":
    main()
