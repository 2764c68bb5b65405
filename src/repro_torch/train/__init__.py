"""Training of the port: AdamW (:mod:`.optimizer`), the microbatched step
(:mod:`.trainer`), async atomic checkpoints (:mod:`.checkpoint`) and the
fault-tolerant loop (:mod:`.loop`), the names of ``repro.train``'s
modules."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    adamw_update,
    init_opt_state,
    lr_schedule,
)
from repro_torch.train.trainer import TrainState, init_train_state, make_loss_fn, make_train_step

__all__ = [
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "adamw_update",
    "lr_schedule",
    "TrainState",
    "make_train_step",
    "make_loss_fn",
    "init_train_state",
    "CheckpointManager",
    "LoopConfig",
    "run_training",
]
