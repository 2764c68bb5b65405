"""The port's training loop, checkpoints and launcher on the CPU: the
twins of ``tests/test_trainer.py`` (the loss falls over 30 steps; a
checkpoint round-trips, is retained and collected; a run crashed at step
9 and resumed from step 8 ends on the uninterrupted run's state bit for
bit; a straggler is counted), an async save committed on ``wait()``,
restores into another dtype (bf16 <-> float32, bf16 stored as its 16-bit
pattern), a corrupt array caught by its CRC32, the new entry points
raising without a card, and ``python -m repro_torch.launch.train`` on the
CPU (trained, resumed, ``--grad-compress``, ``--mesh`` raising).
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import CorpusConfig, TokenPipeline, make_corpus
from repro_torch.train.checkpoint import CheckpointManager, flatten_tree
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import TrainState, init_train_state, make_train_step

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke tensors are tiny: one intra-op thread runs them about three
    times faster than eight, and several test workers then do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = treg.get_smoke_config("olmo-1b")
    opt = AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=60, moment_dtype=torch.float32)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
    step = make_train_step(cfg, opt, n_micro=2)
    tp = TokenPipeline(CorpusConfig(n_docs=64, mean_len=64, vocab=cfg.vocab, seed=1),
                       seq_len=32, device=CPU)
    return cfg, opt, state, step, tp


def _batches(tp, bs):
    """Step-indexed batch function (pure in step: resumable)."""
    def fn(step):
        b = tp.batch_at(step, bs)
        return {"tokens": b["tokens"], "labels": b["labels"]}
    return fn


def _equal_trees(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_loss_decreases(setup):
    cfg, opt, state, step, tp = setup
    fn = _batches(tp, 4)
    losses = []
    for i in range(30):
        state, m = step(state, fn(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_checkpoint_roundtrip(tmp_path, setup):
    cfg, opt, state, step, tp = setup
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    ckpt.save(7, state, blocking=True)
    assert ckpt.latest_step() == 7
    restored = ckpt.restore(7, like=state, device=CPU)
    _equal_trees(state, restored)
    assert type(restored) is TrainState and type(restored.params) is type(state.params)
    assert all(p.requires_grad for p in restored.params.parameters())
    # the restored state trains like the original
    b = _batches(tp, 4)(0)
    _equal_trees(step(state, b)[0], step(restored, b)[0])


def test_checkpoint_retention_and_gc(tmp_path, setup):
    cfg, opt, state, step, tp = setup
    ckpt = CheckpointManager(str(tmp_path / "ck2"), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, state, blocking=True)
    assert ckpt.all_steps() == [3, 4]
    # stale tmp dirs are collected on next manager construction
    os.makedirs(str(tmp_path / "ck2" / "step_000000099.tmp"))
    CheckpointManager(str(tmp_path / "ck2"), keep=2)
    assert not os.path.exists(str(tmp_path / "ck2" / "step_000000099.tmp"))


def test_async_save_commits_on_wait(tmp_path, setup):
    cfg, opt, state, step, tp = setup
    ckpt = CheckpointManager(str(tmp_path / "ck5"), keep=3)
    ckpt.save(1, state)                  # snapshot now, write in the background
    ckpt.wait()
    assert ckpt.all_steps() == [1] and not any(n.endswith(".tmp") for n in os.listdir(ckpt.dir))
    _equal_trees(state, ckpt.restore(1, like=state, device=CPU))


def test_crash_and_resume_exact(tmp_path, setup):
    """Resumed from the step-8 checkpoint, the run ends on the uninterrupted
    run's parameters and moments bit for bit."""
    cfg, opt, state0, step, tp = setup
    loop_dir = str(tmp_path / "loop")

    # uninterrupted reference run
    ck_a = CheckpointManager(loop_dir + "_a", keep=5)
    out_a = run_training(step, state0, _batches(tp, 4), ck_a,
                         LoopConfig(total_steps=12, ckpt_every=4),
                         log=lambda s: None)

    # crash at step 9, then resume from the step-8 checkpoint
    ck_b = CheckpointManager(loop_dir + "_b", keep=5)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(step, state0, _batches(tp, 4), ck_b,
                     LoopConfig(total_steps=12, ckpt_every=4, fail_at_step=9),
                     log=lambda s: None)
    out_b = run_training(step, state0, _batches(tp, 4), ck_b,
                         LoopConfig(total_steps=12, ckpt_every=4),
                         log=lambda s: None)
    assert out_b["resumed_from"] == 8 and len(out_b["losses"]) == 4
    _equal_trees(out_a["final_state"], out_b["final_state"])
    assert out_a["losses"][8:] == out_b["losses"]


def test_straggler_detection(tmp_path, setup):
    cfg, opt, state, step, tp = setup
    calls = {"n": 0, "slowest": 0.0}

    def slow_step(s, b):
        calls["n"] += 1
        if calls["n"] == 9:     # the reference's 0.25 s, or more on a loaded host
            time.sleep(max(0.25, 4 * calls["slowest"]))
        t = time.perf_counter()
        out = step(s, b)
        calls["slowest"] = max(calls["slowest"], time.perf_counter() - t)
        return out

    ck = CheckpointManager(str(tmp_path / "ck4"), keep=1)
    out = run_training(slow_step, state, _batches(tp, 4), ck,
                       LoopConfig(total_steps=10, ckpt_every=100,
                                  straggler_factor=2.5),
                       log=lambda s: None)
    assert out["stragglers"] >= 1


@pytest.mark.parametrize("saved,restored", [(torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.float32)])
def test_restore_into_another_dtype(tmp_path, setup, saved, restored):
    cfg, opt, state, step, tp = setup
    as_saved = dataclasses.replace(opt, moment_dtype=saved)
    src = TrainState(state.params, init_opt_state(state.params, as_saved))
    rng = torch.Generator().manual_seed(2)
    src.opt.mu.update({n: torch.randn(v.shape, generator=rng).to(saved)
                       for n, v in src.opt.mu.items()})
    ckpt = CheckpointManager(str(tmp_path / "ck6"), keep=1)
    ckpt.save(3, src, blocking=True)
    like = TrainState(state.params, init_opt_state(state.params,
                                                   dataclasses.replace(opt, moment_dtype=restored)))
    got = ckpt.restore(3, like=like, device=CPU)
    for n, v in got.opt.mu.items():
        assert v.dtype == restored and torch.equal(v, src.opt.mu[n].to(restored)), n
    if saved == torch.bfloat16:          # bf16 to float32 is exact both ways
        assert all(torch.equal(v.to(saved), src.opt.mu[n]) for n, v in got.opt.mu.items())
    # bf16 is stored as its 16-bit pattern, the true dtype in the metadata
    with np.load(tmp_path / "ck6" / "step_000000003" / "arrays.npz") as npz:
        key = "opt/mu/embed"
        assert npz[key].dtype == (np.uint16 if saved == torch.bfloat16 else np.float32)


def test_corrupt_checkpoint_raises(tmp_path, setup):
    cfg, opt, state, step, tp = setup
    ckpt = CheckpointManager(str(tmp_path / "ck7"), keep=1)
    ckpt.save(1, state.params, blocking=True)
    path = tmp_path / "ck7" / "step_000000001" / "arrays.npz"
    with np.load(path) as npz:
        arrays = {k: npz[k].copy() for k in npz.files}
    arrays["embed"][0, 0] += 1.0
    np.savez(path, **arrays)
    with pytest.raises(IOError, match="checksum mismatch for embed"):
        ckpt.restore(1, like=state.params, device=CPU)


def test_new_entry_points_need_a_card_or_cpu():
    cfg = treg.get_smoke_config("olmo-1b")
    calls = [lambda: init_train_state(cfg, torch.Generator().manual_seed(0), AdamWConfig()),
             lambda: TokenPipeline(CorpusConfig(n_docs=16, mean_len=32), seq_len=16),
             lambda: make_corpus(CorpusConfig(n_docs=16, mean_len=32))]
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ===========================================================================
# The launcher
# ===========================================================================
def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env, timeout=300)


def test_launch_train_on_the_cpu_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _launch("--arch", "olmo-1b", "--device", "cpu", "--steps", "4", "--batch", "4",
                    "--seq", "32", "--ckpt-dir", ck)
    assert first.returncode == 0, first.stderr
    assert "(4 steps, resumed_from=0)" in first.stdout and "raw-document lineage" in first.stdout
    again = _launch("--arch", "olmo-1b", "--device", "cpu", "--steps", "6", "--batch", "4",
                    "--seq", "32", "--ckpt-dir", ck)
    assert again.returncode == 0, again.stderr
    assert "[resume] restored step 4" in again.stdout
    assert "(2 steps, resumed_from=4)" in again.stdout


def test_launch_train_encdec_with_grad_compress(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "whisper-small", "--device", "cpu", "--steps", "2", "--batch", "2",
                "--seq", "16", "--ckpt-dir", str(tmp_path), "--grad-compress"])
    out = capsys.readouterr().out
    assert "(2 steps, resumed_from=0)" in out and "raw-document lineage" in out
    assert os.listdir(tmp_path / "whisper-small") == ["step_000000002"]


def test_launch_train_mesh_and_default_device_raise():
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        for mesh in ("single", "multi"):    # the dry run's fake mesh is the card's by default
            with pytest.raises(RuntimeError, match="no CUDA device"):
                train.main(["--arch", "olmo-1b", "--mesh", mesh])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "olmo-1b"])
