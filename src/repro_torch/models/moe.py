"""Mixture-of-Experts FFN with sort-based token dispatch.

The port of ``repro.models.moe`` (qwen3-moe 128e/top-8, dbrx 16e/top-4,
jamba 16e/top-2):

* router: (T, E) float32 logits of float32 activations against the float32
  router -> top-k expert ids and their softmaxed weights;
* dispatch: each token's k choices become slots ``token * k + j``, stably
  sorted by expert, so the rank of a slot within its expert follows token
  order (a token picks an expert at most once);
* capacity: the first ``cap`` slots of each expert are kept, the rest
  DROPPED; ``cap`` depends on the number of tokens in the call
  (:func:`_capacity`), so a decode step and a full forward can drop
  different tokens;
* expert compute: (E, C, D) x (E, D, F) batched products, then each kept
  slot's output, times its router weight, is added back to its token.

The reference reshapes the tokens into G groups, one per data shard, when
its sharding policy asks for it (``_n_groups``); the port has no such
policy (it waits for the device mesh), so G is always 1, as in the
reference without one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

__all__ = ["MoE", "init_moe", "moe_forward"]


class MoE(nn.Module):
    """``router`` (d, E), and per expert (leading axis) ``wi``/``wg`` (E, d,
    f) and ``wo`` (E, f, d)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = C._param((d, e), device)
        self.wi = C._param((e, d, f), device)
        self.wg = C._param((e, d, f), device)
        self.wo = C._param((e, f, d), device)


def init_moe(cfg: ModelConfig, generator: torch.Generator, device=None) -> MoE:
    """Standard normal weights over sqrt(fan-in)."""
    m = MoE(cfg, device)
    for w, fan_in in ((m.router, cfg.d_model), (m.wi, cfg.d_model), (m.wg, cfg.d_model),
                      (m.wo, cfg.d_ff)):
        w.normal_(generator=generator).div_(math.sqrt(fan_in))
    return m


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert: ``capacity_factor`` times the even share of the
    call's tokens, rounded up to a multiple of 8, at least 8."""
    per = tokens_per_group * cfg.top_k / cfg.n_experts
    c = int(math.ceil(per * cfg.capacity_factor / 8.0)) * 8
    return max(c, 8)


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    dev = x.device
    xt = x.reshape(t, d)

    # router
    logits = xt.float() @ p.router.float()                      # (T, E)
    topw, topi = torch.topk(logits, k, dim=-1)                   # (T, k)
    topw = torch.softmax(topw, dim=-1).to(dt)

    # sort-based dispatch: slot token * k + j, stable by expert
    flat_e = topi.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = torch.div(order, k, rounding_mode="floor")      # the slot's token
    starts = torch.searchsorted(e_sorted, torch.arange(e, dtype=e_sorted.dtype, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]

    cap = _capacity(cfg, t)
    slot = torch.where(rank < cap, e_sorted * cap + rank, e * cap)  # overflow: sentinel
    # slot -> token (default: the zero row t) and slot -> router weight; the
    # sentinel slot e * cap is written by every dropped choice, then cut off
    tok_of_slot = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    tok_of_slot[slot] = tok_sorted
    w_of_slot = torch.zeros(e * cap + 1, dtype=dt, device=dev)
    w_of_slot[slot] = topw.reshape(t * k)[order]
    tok_of_slot, w_of_slot = tok_of_slot[:e * cap], w_of_slot[:e * cap]

    xt_pad = torch.cat([xt, xt.new_zeros(1, d)], dim=0)
    buf = xt_pad[tok_of_slot].reshape(e, cap, d)                 # (E, C, D)
    g = torch.bmm(buf, p.wg.to(dt))
    h = g * torch.sigmoid(g) * torch.bmm(buf, p.wi.to(dt))
    y = torch.bmm(h, p.wo.to(dt)).reshape(e * cap, d)            # (E*C, D)

    out = x.new_zeros(t + 1, d)
    out.index_add_(0, tok_of_slot, y * w_of_slot[:, None])
    return out[:t].reshape(b, s, d)
