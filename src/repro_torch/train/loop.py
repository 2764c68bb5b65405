"""Fault-tolerant training loop: checkpoint/restart, stragglers, crash hook.

The port of ``repro.train.loop``, one process on one device, or each
rank of a mesh running the same loop over a state of DTensors:

* RESUME: on start, restore the latest complete checkpoint (atomic
  directories, so a crash mid-save never corrupts the resume point) onto
  the state's device and continue from its step; the data is re-seeked
  from the step, since ``batch_fn`` is a pure function of it;
* PERIODIC + FINAL checkpoints, written asynchronously;
* STRAGGLER DETECTION: every step is timed on the host clock up to a
  device synchronisation; after 5 steps, a step slower than
  ``straggler_factor`` times the running median is logged and counted;
* CRASH INJECTION (tests): ``fail_at_step`` raises mid-run, to prove that
  a restart resumes bit-exact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.train.checkpoint import CheckpointManager, tree_device
from repro_torch.train.trainer import TrainState

__all__ = ["LoopConfig", "run_training"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None   # test hook: simulated crash


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(
    train_step: Callable,
    state: TrainState,
    batch_fn: Callable[[int], Dict[str, Any]],
    ckpt: CheckpointManager,
    cfg: LoopConfig,
    state_shardings: Optional[Any] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run steps ``[resume point, cfg.total_steps)``.  ``batch_fn(step)``
    MUST be a pure function of the step (the data pipeline is deterministic
    and resumable), so a restart re-seeks exactly.  ``state_shardings``
    (:func:`~repro_torch.launch.sharding.to_shardings` of the state's
    specs) places a restored state on its mesh."""
    dev = tree_device(state)
    start_step = 0
    ckpt.wait()  # an in-flight async save (e.g. of a crashed earlier run on
    # this manager) must commit before the resume point is resolved
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, like=state, device=dev, shardings=state_shardings)
        start_step = latest
        log(f"[resume] restored step {latest}")

    step_times: List[float] = []
    stragglers = 0
    losses: List[float] = []

    for step in range(start_step, cfg.total_steps):
        batch = batch_fn(step)
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")

        _synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        _synchronize(dev)
        dt = time.perf_counter() - t0

        if len(step_times) >= 5:
            p50 = float(np.median(step_times))
            if dt > cfg.straggler_factor * p50:
                stragglers += 1
                log(f"[straggler] step {step}: {dt*1e3:.1f} ms vs p50 {p50*1e3:.1f} ms")
        step_times.append(dt)
        losses.append(float(metrics["loss"]))

        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            ckpt.save(step + 1, state)

    ckpt.wait()
    return {
        "final_state": state,
        "losses": losses,
        "step_times": step_times,
        "stragglers": stragglers,
        "resumed_from": start_step,
    }
