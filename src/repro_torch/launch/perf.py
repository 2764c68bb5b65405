"""§Perf hillclimb driver: account for one cell under named optimizer/layout
variants and report the roofline deltas.

The port of ``repro.launch.perf``, on :func:`repro_torch.launch.dryrun.lower_cell`
(one step on fake-group DTensors with meta shards, counted as it runs,
extended from a few blocks and microbatches to the config's).

    PYTHONPATH=src python -m repro_torch.launch.perf --device-type cpu \
        --arch olmo-1b --shape train_4k --mesh single --variant base --variant lowmem

Variants:
  base       AdamW, float32 gradient accumulation, bf16 moments (the default)
  lowmem     bf16 gradient accumulation: the port accumulates ``.grad`` in the
             parameters' dtype, so the parameters are held in bf16 too
  compress   lowmem + int8 error-feedback gradient compression
  sp         lowmem + the sequence-parallel residual stream over "model"
  dponly     pure data parallelism over every mesh axis, no TP
  rematdots  remat policy "dots": save the weight products, recompute the rest
"""
import argparse
import json
import os

import torch

from repro_torch.launch.dryrun import fake_production_mesh, lower_cell
from repro_torch.train.optimizer import AdamWConfig

VARIANTS = {
    "base": (AdamWConfig(), None),
    "lowmem": (AdamWConfig(accum_dtype=torch.bfloat16), None),
    "compress": (AdamWConfig(accum_dtype=torch.bfloat16, grad_compress_bits=8), None),
    # sequence-parallel residual stream over the model axis (Megatron-SP)
    "sp": (AdamWConfig(accum_dtype=torch.bfloat16), {"sp": "model"}),
    # pure data parallelism, no TP — the small-model layout (whisper)
    "dponly": (AdamWConfig(), "dp_only"),
    # remat policy: save matmul outputs instead of recomputing everything
    "rematdots": (AdamWConfig(), {"__cfg__": {"remat_policy": "dots"}}),
}


def run_variant(arch: str, shape: str, mesh, name: str, n_micro=None):
    """One variant's record (``hlo`` and ``memory`` as the reference's)."""
    opt, pol = VARIANTS[name]
    layout = pol if isinstance(pol, str) else "fsdp_tp"
    extra = dict(pol) if isinstance(pol, dict) else None
    cfg_over = extra.pop("__cfg__", None) if extra else None
    acct = lower_cell(arch, shape, mesh, opt_cfg=opt, policy_extra=extra or None,
                      layout=layout, cfg_overrides=cfg_over, n_micro_override=n_micro,
                      extrapolate=True)
    ma = acct.memory_analysis()
    return {
        "variant": name,
        "hlo": acct.stats.as_dict(),
        "memory": {
            "argument_size_in_bytes": ma.argument_size_in_bytes,
            "temp_size_in_bytes": ma.temp_size_in_bytes,
            "output_size_in_bytes": ma.output_size_in_bytes,
        },
        "status": "ok",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="the fake mesh's device type (cuda needs a card)")
    args = ap.parse_args(argv)

    results = []
    with fake_production_mesh(args.mesh, args.device_type) as mesh:
        for name in (args.variant or ["base"]):
            rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                   **run_variant(args.arch, args.shape, mesh, name, args.n_micro)}
            results.append(rec)
            h, m = rec["hlo"], rec["memory"]
            print(f"[{name:9s}] args={m['argument_size_in_bytes']/1e9:.2f}GB "
                  f"temp={m['temp_size_in_bytes']/1e9:.2f}GB "
                  f"dotF={h['dot_flops']:.3e} traffic={h['traffic_bytes']:.3e} "
                  f"coll={h['collective_bytes']:.3e}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)


if __name__ == "__main__":
    main()
