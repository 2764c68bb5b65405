"""Serving launcher.

* LOCAL (default): run the batched ServeEngine on a reduced config of any
  of the ten architectures (an encoder-decoder gets random frames) —
  generates real tokens on ``--device`` (default: the card) and reports
  per-token latency.
* TIER (--tier): additionally record request/response provenance and drive
  per-request lineage probes through the async micro-batching
  :class:`~repro_torch.serve.tier.ServingTier` (fuse-key batching +
  admission), reporting fused-batch stats and probe throughput.
* PROD (--mesh single|multi): accounts for one decode step of the FULL
  config's decode_32k cell on the production mesh (a fake process group
  of 256 or 512 ranks) and prints the record
  (:func:`repro_torch.launch.dryrun.run_cell`); ``--device cpu`` gives the
  mesh the CPU device type.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --tier
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --mesh multi --device cpu
"""
import argparse
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default="local")
    ap.add_argument("--dry-run", action="store_true",
                    help="accepted as the reference accepts it: --mesh always dry-runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--tier", action="store_true",
                    help="record provenance and serve per-request lineage "
                         "probes through the micro-batching ServingTier")
    ap.add_argument("--probes", type=int, default=64,
                    help="lineage probes to push through the tier (--tier)")
    args = ap.parse_args(argv)

    if args.mesh != "local":
        from repro_torch.launch.dryrun import fake_production_mesh, run_cell
        device_type = "cpu" if args.device == "cpu" else "cuda"
        with fake_production_mesh(args.mesh, device_type) as mesh:
            rec = run_cell(args.arch, "decode_32k", mesh, args.mesh)
        print({k: v for k, v in rec.items() if k != "trace"})
        sys.exit(0 if rec["status"] in ("ok", "skip") else 1)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (args.batch, 8)).astype(np.int32)
    frames = (rng.normal(size=(args.batch, cfg.enc_seq, cfg.d_model))
              .astype(np.float32) if cfg.is_encdec else None)

    engine = ServeEngine(cfg, params, max_seq=8 + args.n_new, dtype=torch.float32,
                         device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new=args.n_new, frames=frames,
                          record_provenance=args.tier)
    dt = time.perf_counter() - t0
    print(f"generated {out.tokens.shape} on {dev} in {dt:.2f}s "
          f"({dt / args.n_new * 1e3:.1f} ms/token incl. prompt pass)")
    print("first rows:", out.tokens[:2].tolist())

    if args.tier:
        from repro_torch.provenance import prov
        from repro_torch.serve.tier import ServingTier
        req = out.request_dataset
        resp = out.response_dataset
        with ServingTier(engine.as_backend(), max_batch=32,
                         max_wait_ms=2.0) as tier:
            t0 = time.perf_counter()
            futs = [
                tier.submit_nowait(
                    f"tenant-{i % 4}",
                    prov(engine.prov).source(resp).rows([i % args.batch])
                    .backward().to(req).plan())
                for i in range(args.probes)
            ]
            results = [f.result(timeout=60.0) for f in futs]
            dt = time.perf_counter() - t0
        stats = tier.stats()
        fused = stats["tier"]["batches"]
        print(f"tier: {len(results)} lineage probes in {dt * 1e3:.1f} ms "
              f"({len(results) / max(dt, 1e-9):.0f}/s) across {fused} fused "
              f"batches (max width {stats['tier']['max_batch_seen']})")
        print("tier stats:", {k: stats["tier"][k] for k in
                              ("submitted", "completed", "batches",
                               "flush_full", "flush_timer")})


if __name__ == "__main__":
    main()
