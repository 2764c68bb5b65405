"""Time and peak memory of OLMo-1B's sharded train step on one card.

The step ``chip_smoke.py``'s mesh phase runs: OLMo-1B at full width,
train_4k's settings cut to global batch 8 (seq 4,096, ``n_micro`` 2,
remat "nothing", ``q_chunk`` 0), under deterministic algorithms, once
plain and once with its state and batch placed on a (1, 1) ("data",
"model") mesh by ``launch.sharding`` (world size 1 on NCCL).  For each, two
steps from a fresh state: the second step's milliseconds and the most
bytes the card held above what was allocated before the state was built
(``max_memory_allocated``), the plain state freed before the sharded one
is built.  ``--src`` names the ``src`` directory of the port to measure
(default this checkout's), so two checkouts compare in one call:

    python3 tools/olmo_mesh_step.py [--src path/to/src]

Prints one JSON object with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

SEED = 0
BATCH, SEQ = 8, 4_096


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import sharding as SD
    from repro_torch.launch.mesh import init_world, make_mesh, use_mesh
    from repro_torch.models import pshard as PS
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = get_config("olmo-1b")
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(cfg, opt, n_micro=2, q_chunk=0)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (BATCH, SEQ)))
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, dims=1).to(dev)}

    def two_steps(place):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), opt, dev)
        state, b = place(state)
        state, met = step(state, b)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        loss = float(met["loss"])
        del state, b, met
        return {"ms": ms, "peak_bytes": int(peak), "loss": loss}

    init_world(0, 1, store=dist.HashStore(), device_type="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        plain = two_steps(lambda s: (s, batch))
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")

        def place(s):
            s = SD.place(s, SD.to_shardings(SD.state_pspecs(cfg, s, mesh), mesh))
            return s, SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))

        with use_mesh(mesh), PS.use_policy({"dp": ("data",), "tp": "model"}):
            sharded = two_steps(place)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    print(json.dumps({"src": args.src, "card": _card(), "torch": torch.__version__,
                      "plain": plain, "sharded": sharded,
                      "loss_equal": plain["loss"] == sharded["loss"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
