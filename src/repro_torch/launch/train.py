"""Training launcher.

* LOCAL (default): trains a reduced (smoke) config of ``--arch`` on
  ``--device`` (default: the card) with the provenance-carrying data
  pipeline, the fault-tolerant loop and async checkpoints; rerun with the
  same ``--ckpt-dir`` and it resumes from the latest checkpoint.
* PROD (--mesh single|multi) is not ported yet: the device mesh and the
  sharding layouts are (``launch.mesh``, ``launch.sharding``), the dry-run
  accounting of the full config's step on them is not (ROADMAP A14b).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --device cpu --steps 30
"""
import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default="local")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--grad-compress", action="store_true")
    args = ap.parse_args(argv)

    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the dry-run accounting of the full config's train "
            "step on the production mesh is not ported yet (ROADMAP A14b)")

    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import CorpusConfig, TokenPipeline
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=args.steps,
                      grad_compress_bits=8 if args.grad_compress else 0)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), opt, dev)
    step = make_train_step(cfg, opt, n_micro=2)
    tp = TokenPipeline(CorpusConfig(n_docs=256, mean_len=128, vocab=cfg.vocab, seed=0),
                       seq_len=args.seq, device=dev)

    def batch_fn(s):
        b = tp.batch_at(s, args.batch, record_provenance=True)
        out = {"tokens": b["tokens"], "labels": b["labels"]}
        if cfg.is_encdec:   # random frames, a pure function of the step
            gen = torch.Generator(device=dev).manual_seed(s)
            out["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                                        generator=gen, device=dev)
        return out

    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, args.arch), keep=2)
    out = run_training(step, state, batch_fn, ckpt,
                       LoopConfig(total_steps=args.steps, ckpt_every=10))
    if out["losses"]:
        print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"({len(out['losses'])} steps, resumed_from={out['resumed_from']})")
    else:
        print(f"no step left to run (resumed_from={out['resumed_from']})")
    tp.batch_at(0, args.batch, record_provenance=True)  # a resumed run skipped step 0
    print(f"batch 0 raw-document lineage: {len(tp.batch_to_documents(0))} docs")


if __name__ == "__main__":
    main()
