"""Batched serving with request-level lineage through the serving tier, on the port.

    PYTHONPATH=src python examples/torch/serve_with_lineage.py              # the card
    PYTHONPATH=src python examples/torch/serve_with_lineage.py --device cpu

The twin of ``examples/serve_with_lineage.py`` on ``repro_torch``, on the
same seeded prompts (the model's weights are random and differ from the
original's, so the generated tokens do; the lineage does not).  Serves a
small decoder LM (smoke-size gemma3 family: the local:global interleave
and ring caches on the decode path) over a batch of requests.  The engine
owns its OWN provenance index wrapped in a single-entry
:class:`ProvCatalog` (``engine.catalog``): serving-local lineage routes
through the index's shared ``QuerySession``, and the same catalog is where
an upstream data-prep boundary attaches (``upstream=prep_index.export(...)``
— see ``examples/torch/federated_lineage.py``).

Per-request lineage probes are served through the async micro-batching
:class:`~repro_torch.serve.tier.ServingTier` (``engine.as_backend()``):
concurrent tenants submit single-probe plans, the tier coalesces them by
fuse key into fused ``run_many`` passes, and admission scopes each tenant
to a capability ref set.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.provenance import prov
from repro_torch.serve import ServingTier
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_smoke_config("gemma3-1b")
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    B, SP, NEW = 4, 8, 6
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab, (B, SP)).astype(np.int32)

    engine = ServeEngine(cfg, params, max_seq=SP + NEW, dtype=torch.float32, device=dev)
    # the engine's serving index is registered in its catalog under "serve";
    # the shared session's cost model routes per plan — cheap adjacent
    # (response -> request) hops stay on the walk, and sustained probe demand
    # against a distant pair amortizes a composition and flips to the hop-cache
    print("catalog:", engine.catalog)
    result = engine.generate(prompts, n_new=NEW,
                             request_ids=np.array([101, 102, 103, 104]),
                             record_provenance=True)
    print("generated tokens:\n", result.tokens)
    print("recorded:", result.request_dataset, "->", result.response_dataset)

    # --- per-request lineage through the shared session ------------------------
    print("\nQ2: response row 2 derives from request row:",
          engine.response_lineage(result, rows=[2]).cpu().numpy(),
          "(request_id", int(result.request_ids[2]), ")")

    # batched per-request lineage: every response row traced in ONE fused probe
    per_request = engine.response_lineage_batch(result, [[i] for i in range(B)])
    print("Q2 batch: response row -> request row:",
          {i: r.tolist() for i, r in enumerate(per_request)})

    # --- the same probes, served: the async micro-batching tier -----------------
    # many tenants each trace THEIR response row; same-shape plans coalesce
    # into fused passes (bare serving-local refs are qualified by the backend)
    with ServingTier(engine.as_backend(), max_batch=16, max_wait_ms=2.0) as tier:
        futs = [
            tier.submit_nowait(
                f"tenant-{i % 2}",
                prov(engine.prov).source(result.response_dataset).rows([i])
                .backward().to(result.request_dataset).plan())
            for i in range(B)
        ]
        served = [f.result(timeout=60.0) for f in futs]
    if not all(s.tolist() == r.tolist() for s, r in zip(served, per_request)):
        raise SystemExit("the tier's answers differ from response_lineage_batch")
    stats = tier.stats()
    print("tier: served", stats["tier"]["completed"], "probes in",
          stats["tier"]["batches"], "fused batch(es), max width",
          stats["tier"]["max_batch_seen"])

    # forward plans run through the same session/composed relations — spelled
    # either against the index or against the catalog with a qualified ref
    print("Q1: request row 0 produced response rows:",
          prov(engine.prov).source(result.request_dataset).rows([0])
          .forward().to(result.response_dataset).run(engine.session).cpu().numpy())
    print("Q1 (catalog ref):",
          prov(engine.catalog).source(f"serve/{result.request_dataset}").rows([0])
          .forward().to(f"serve/{result.response_dataset}").run().cpu().numpy())

    print("\nsession stats (shared composed relations):", engine.session.stats())
    print("federation stats (single-entry catalog):",
          engine.federation.stats()["federation"])
    print("provenance bytes for the serving path:", engine.prov.prov_nbytes())


if __name__ == "__main__":
    main()
