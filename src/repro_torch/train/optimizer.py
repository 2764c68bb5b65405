"""AdamW with bf16 moments and int8 error-feedback gradient compression.

The port of ``repro.train.optimizer``:

* AdamW with decoupled weight decay and global-norm clipping;
* a configurable MOMENT dtype (bf16 moments: 4 bytes of optimizer state a
  parameter instead of 8);
* optional int8 GRADIENT COMPRESSION with error feedback: each gradient
  leaf is fake-quantized to a per-leaf int8 scale, the residual is carried
  in the state and added back at the next step (the arithmetic of an int8
  all-reduce; the collective itself waits for the device mesh, ROADMAP A14);
* linear-warmup + cosine LR schedule.

A tree here is a mapping from the model's parameter names to tensors (the
order of ``named_parameters()``): the parameters, their gradients and each
moment.  The arithmetic is the reference's op for op in float32 tensors:
the schedule and ``b ** t`` are float32, as they are in JAX (not Python
floats), the global norm is a sum of per-leaf float32 sums of squares in
leaf order, and ``torch.round`` rounds half to even as ``jnp.round`` does.
Every update returns new tensors; the inputs are not written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "lr_schedule"]

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.bfloat16   # bf16 moments: 4 B/param of moments
    accum_dtype: torch.dtype = torch.float32     # microbatch grad-accumulation dtype
    grad_compress_bits: int = 0                  # 0 = off, 8 = int8 error-feedback


class OptState(NamedTuple):
    step: torch.Tensor        # 0-dim int32, on the parameters' device
    mu: Tree                  # first moment (moment_dtype)
    nu: Tree                  # second moment (moment_dtype)
    err: Optional[Tree]       # error-feedback residual (only when compressing)


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Tree:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_opt_state(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                   cfg: AdamWConfig) -> OptState:
    """Zero moments (and residuals when compressing) beside ``params``, a
    module or a tree."""
    named = _named(params)
    dev = next(iter(named.values())).device
    with torch.no_grad():
        zeros = lambda dtype=None: {n: torch.zeros_like(p, dtype=dtype or p.dtype)  # noqa: E731
                                    for n, p in named.items()}
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        mu=zeros(cfg.moment_dtype), nu=zeros(cfg.moment_dtype),
                        err=zeros() if cfg.grad_compress_bits else None)


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak`` over ``warmup_steps``, then a cosine to 0
    at ``total_steps`` (0 past it): a 0-dim float32 tensor for an int32
    ``step``, computed in float32 as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.int32)
    dev = step.device
    warm = _f32(cfg.lr_peak, dev) * (step + 1).float() / _f32(max(cfg.warmup_steps, 1), dev)
    span = _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev)
    prog = torch.clamp((step - cfg.warmup_steps).float() / span, 0.0, 1.0)
    cos = _f32(cfg.lr_peak * 0.5, dev) * (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum, in leaf order, of each leaf's float32 sum of
    squares."""
    sq = None
    for x in tree.values():
        s = torch.sum(torch.square(x.float()))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _fake_quant_int8(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization of one gradient leaf: (the
    quantized-and-dequantized gradient, the new residual).  The value
    returned is what the receiving side of an int8 all-reduce would see."""
    g = g.float() + err.float()
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / _f32(127.0, g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale
    return deq, g - deq


@torch.no_grad()
def adamw_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: OptState,
    cfg: AdamWConfig,
) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, ``{"grad_norm", "lr"}``).
    ``params``, ``grads`` and the state's trees share their keys."""
    step = state.step
    dev = step.device

    # --- gradient compression (int8 reduce emulation + error feedback) ------
    if cfg.grad_compress_bits == 8:
        pairs = {n: _fake_quant_int8(g, state.err[n]) for n, g in grads.items()}
        grads = {n: pr[0] for n, pr in pairs.items()}
        new_err = {n: pr[1] for n, pr in pairs.items()}
    else:
        new_err = state.err

    # --- global-norm clip ---------------------------------------------------
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(_f32(cfg.clip_norm, dev) / (gnorm + _f32(1e-12, dev)), 1.0)
    grads = {n: g.float() * clip for n, g in grads.items()}

    # --- Adam moments (kept in moment_dtype) --------------------------------
    t = (step + 1).float()
    bc1 = _f32(1.0, dev) - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = _f32(1.0, dev) - torch.pow(_f32(cfg.b2, dev), t)
    lr = lr_schedule(cfg, step)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    new_p, new_mu, new_nu = {}, {}, {}
    for n, p in params.items():
        g = grads[n]
        m32 = b1 * state.mu[n].float() + c1 * g
        v32 = b2 * state.nu[n].float() + c2 * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        new_p[n] = (p.float() - lr * delta).to(p.dtype)
        new_mu[n] = m32.to(cfg.moment_dtype)
        new_nu[n] = v32.to(cfg.moment_dtype)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step + 1, new_mu, new_nu, new_err), metrics
