"""End-to-end driver: train a ~100M LM with TensProv lineage on the data path, on the port.

    PYTHONPATH=src python examples/torch/train_with_provenance.py [--steps 200] [--tiny]
    PYTHONPATH=src python examples/torch/train_with_provenance.py --tiny --steps 6 --device cpu

The twin of ``examples/train_with_provenance.py`` on ``repro_torch``, on
the same seeded corpus (the model's weights are random and differ from the
original's, so the losses do; the data path and its lineage do not).
What it demonstrates (the paper's technique as a training-framework
feature):

  1. the corpus -> filter -> dedup -> pack -> batch dataflow is captured as
     a TensProv pipeline (sparse binary tensors per step);
  2. a ~100M-parameter decoder LM trains for a few hundred steps with the
     fault-tolerant loop (async checkpoints, resumable data order);
  3. DURING training, lineage queries answer development-time questions:
     'which raw documents fed the worst-loss batch?' (Q2 backward) and
     'which batches did a flagged document reach?' (Q1 forward), through
     the unified repro_torch.provenance query API;
  4. a consent audit over every trained batch's lineage (paper §IV).
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import CorpusConfig, TokenPipeline
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import init_train_state, make_train_step


def model_100m(tiny: bool) -> ModelConfig:
    if tiny:
        return ModelConfig(name="lm-tiny", family="dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab=50_000, block=(LayerSpec(),), remat=False)
    return ModelConfig(name="lm-100m", family="dense", n_layers=10,
                       d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                       vocab=50_000, block=(LayerSpec(),), remat=False)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "tensprov_train_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_100m(args.tiny)
    n_params = cfg.n_params()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    # --- provenance-carrying data pipeline --------------------------------
    tp = TokenPipeline(CorpusConfig(n_docs=1024, mean_len=256, vocab=cfg.vocab, seed=11),
                       seq_len=args.seq, device=dev)
    print(f"corpus: {tp.index.datasets['corpus'].n_rows} docs -> "
          f"{tp.n_seq} packed sequences; prov bytes so far: "
          f"{tp.index.stats()['prov_bytes']:,}")

    # --- trainer -----------------------------------------------------------
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=20, total_steps=args.steps)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), opt, dev)
    step_fn = make_train_step(cfg, opt, n_micro=2)

    def batch_fn(step):
        b = tp.batch_at(step, args.batch, record_provenance=True)
        return {"tokens": b["tokens"], "labels": b["labels"]}

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    t0 = time.time()
    out = run_training(step_fn, state, batch_fn, ckpt,
                       LoopConfig(total_steps=args.steps, ckpt_every=50))
    dt = time.time() - t0
    losses = out["losses"]
    print(f"\ntrained {len(losses)} steps in {dt:.1f}s "
          f"({dt/max(len(losses),1):.2f}s/step); "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}; "
          f"stragglers observed: {out['stragglers']}")

    # --- development-time provenance queries (the paper's use case) --------
    worst = int(np.argmax(losses))
    docs = tp.batch_to_documents(worst)
    meta = tp.index.datasets["corpus"].table
    print(f"\nworst-loss batch = step {worst} (loss {losses[worst]:.3f})")
    print(f"  Q2: fed by {len(docs)} raw documents; "
          f"mean quality {float(meta.col('quality')[docs].mean()):.3f} "
          f"(corpus mean {float(meta.col('quality').mean()):.3f})")

    flagged = int(docs[0])
    print(f"  Q1: document {flagged} reached batches "
          f"{tp.document_to_batches(flagged)[:10]}")

    # --- consent audit over every trained batch's lineage --------------------
    consent = (meta.col("consent") > 0).cpu()
    bad = []
    for s in range(min(args.steps, len(losses))):
        if f"batch@{s}" in tp.index.datasets:
            for d in tp.batch_to_documents(s).tolist():
                if not consent[d]:
                    bad.append((s, d))
    print(f"\nconsent audit: {len(bad)} (batch, doc) pairs used "
          f"non-consenting documents; first 5: {bad[:5]}")
    print("-> with provenance these batches can be traced, the documents "
          "dropped, and exactly the affected steps replayed.")

    print(f"\nfinal provenance index: {tp.index.stats()}")


if __name__ == "__main__":
    main()
