"""The training step: loss, microbatched gradient accumulation, optimizer.

The port of ``repro.train.trainer``.  ``make_train_step`` builds the
``(state, batch) -> (state, metrics)`` function the loop and the launcher
run:

* next-token cross-entropy with -1-masked labels (pad / document joints);
* gradient accumulation over ``n_micro`` microbatches: the global batch is
  split on its first axis, each microbatch's loss is back-propagated in
  turn and its gradient added into ``.grad`` (float32 master weights, so
  the sum is in float32, as the reference's ``lax.scan`` sums it in
  ``accum_dtype``), then divided by ``n_micro``; peak activation memory is
  one microbatch's;
* rematerialisation as the model config says (``cfg.remat``, per block);
* AdamW from :mod:`repro_torch.train.optimizer`;
* DTensor parameters and batches (placed by
  :mod:`repro_torch.launch.sharding`): the same step, every op on
  DTensors, the loss reduced over the sharded rows.

The step is functional as the reference's is: it returns a new
:class:`TrainState` (new parameter tensors and moments) and leaves the one
it was given as it was, apart from clearing its parameters' ``.grad``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import rebind, trainable
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

__all__ = ["TrainState", "make_train_step", "make_loss_fn", "init_train_state", "cross_entropy"]

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: nn.Module
    opt: OptState


def init_train_state(cfg: ModelConfig, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device=None) -> TrainState:
    """Random float32 parameters that require a gradient, drawn from
    ``generator``, and zero moments, on ``device`` (``None``: the card,
    raising without one)."""
    params = trainable(get_model(cfg).init_params(cfg, generator, device))
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def _mesh_scope(named: Dict[str, torch.Tensor]):
    """DTensor's ``implicit_replication`` for a step over DTensor
    parameters: the tensors the model builds from shapes alone (RoPE
    angles, masks, positions) are the same on every rank and are taken as
    replicated.  An op without a DTensor rule still raises."""
    if any(isinstance(p, DTensor) for p in named.values()):
        return implicit_replication()
    return contextlib.nullcontext()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean NLL of float32 logits (B, S, V): labels == -1 are
    ignored.  Returns (loss, number of unmasked labels, at least 1)."""
    mask = (labels >= 0).float()
    safe = torch.clamp_min(labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    if isinstance(loss, DTensor):     # a sum over sharded rows: reduce it
        loss, denom = loss.full_tensor(), denom.full_tensor()
    return loss, denom


def make_loss_fn(cfg: ModelConfig, q_chunk: int = 0,
                 dtype: torch.dtype = torch.bfloat16) -> Callable[[nn.Module, Batch], torch.Tensor]:
    """``loss_fn(params, batch)``: the mean NLL of ``batch["labels"]`` under
    the model's forward in ``dtype`` (an encoder-decoder also reads
    ``batch["frames"]``)."""
    model = get_model(cfg)

    def loss_fn(params: nn.Module, batch: Batch) -> torch.Tensor:
        if cfg.is_encdec:
            logits = model.forward(cfg, params, batch["frames"], batch["tokens"],
                                   q_chunk=q_chunk, dtype=dtype)
        else:
            logits = model.forward(cfg, params, batch["tokens"], q_chunk=q_chunk, dtype=dtype)
        return cross_entropy(logits, batch["labels"])[0]

    return loss_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    n_micro: int = 1,
    q_chunk: int = 0,
    dtype: torch.dtype = torch.bfloat16,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step over a global batch whose first axis ``n_micro`` divides;
    metrics ``loss`` (the mean of the microbatch losses), ``grad_norm`` and
    ``lr``, 0-dim float32 tensors on the parameters' device.  The forward
    runs in ``dtype``; the parameters must be held in ``opt_cfg.accum_dtype``,
    in which their gradients accumulate."""
    loss_fn = make_loss_fn(cfg, q_chunk, dtype)

    def train_step(state: TrainState, batch: Batch):
        named = dict(state.params.named_parameters())
        with _mesh_scope(named):
            return _step(state, batch, named)

    def _step(state: TrainState, batch: Batch, named: Dict[str, torch.Tensor]):
        odd = {p.dtype for p in named.values()} - {opt_cfg.accum_dtype}
        if odd:
            raise ValueError(f"gradients accumulate in the parameters' dtype: "
                             f"{sorted(map(str, odd))} parameters, "
                             f"accum_dtype {opt_cfg.accum_dtype}")
        for p in named.values():
            p.grad = None
        if n_micro > 1:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch of {b} does not split into {n_micro} microbatches")
            micro = {k: torch.split(v, b // n_micro) for k, v in batch.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=micro["labels"][0].device)
            for i in range(n_micro):
                loss = loss_fn(state.params, {k: v[i] for k, v in micro.items()})
                loss.backward()
                loss_sum = loss_sum + loss.detach()
            loss = loss_sum / n_micro
        else:
            loss = loss_fn(state.params, batch)
            loss.backward()
            loss = loss.detach()
        grads = {}
        for n, p in named.items():    # the state's params keep no gradient
            g = p.grad.div_(n_micro) if n_micro > 1 else p.grad
            if isinstance(g, DTensor) and g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)   # reduce partial sums
            grads[n] = g
            p.grad = None
        new_params, new_opt, metrics = adamw_update(named, grads, state.opt, opt_cfg)
        del grads
        return (TrainState(rebind(state.params, new_params), new_opt),
                {"loss": loss, **metrics})

    return train_step
