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

GROUPS: the tokens are reshaped into G groups, G = the sharding policy's
``moe_groups`` where it divides the tokens (:func:`_n_groups`; 1 without a
policy), and each group is routed, dispatched and dropped on its own with
a capacity per group, as the reference does.  The launcher sets G = the
number of data shards, so each group is one data shard's tokens: on a
DTensor the groups are hinted over the data axes and each rank runs its
own groups locally (``local_map``), with the experts' weights gathered
whole.  Expert parallelism over "model" is not done: the ``buf`` hint is
the identity on local groups.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import pshard as PS

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


def _n_groups(t: int) -> int:
    """G = the policy's ``moe_groups`` where it divides the T tokens, else 1."""
    pol = PS.policy() or {}
    g = int(pol.get("moe_groups", 1) or 1)
    return g if (g > 1 and t % g == 0) else 1


def _grouped(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
             wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The FFN of every group of xt (G, Tg, D) -> (G, Tg, D), each group
    routed, dispatched and dropped on its own."""
    g, tg, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xt.dtype
    dev = xt.device

    # router
    logits = xt.float() @ router.float()                        # (G, Tg, E)
    topw, topi = torch.topk(logits, k, dim=-1)                   # (G, Tg, k)
    topw = torch.softmax(topw, dim=-1).to(dt)

    # sort-based dispatch: slot token * k + j, stable by expert, per group
    flat_e = topi.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    tok_sorted = torch.div(order, k, rounding_mode="floor")      # the slot's token
    eids = torch.arange(e, dtype=e_sorted.dtype, device=dev).expand(g, e).contiguous()
    starts = torch.searchsorted(e_sorted, eids)                  # (G, E)
    rank = torch.arange(tg * k, device=dev) - torch.gather(starts, 1, e_sorted)

    cap = _capacity(cfg, tg)
    slot = torch.where(rank < cap, e_sorted * cap + rank, e * cap)  # overflow: sentinel
    # slot -> token (default: the zero row tg) and slot -> router weight; the
    # sentinel slot e * cap is written by every dropped choice, then cut off
    tok_of_slot = torch.full((g, e * cap + 1), tg, dtype=torch.int64, device=dev)
    tok_of_slot.scatter_(1, slot, tok_sorted)
    w_of_slot = torch.zeros((g, e * cap + 1), dtype=dt, device=dev)
    w_of_slot.scatter_(1, slot, torch.gather(topw.reshape(g, tg * k), 1, order))
    tok_of_slot, w_of_slot = tok_of_slot[:, :e * cap], w_of_slot[:, :e * cap]

    # the rows of group j live at j * (tg + 1) of the padded token stream
    rows = (tok_of_slot + torch.arange(g, device=dev)[:, None] * (tg + 1)).reshape(g * e * cap)
    xt_pad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1).reshape(g * (tg + 1), d)
    buf = xt_pad[rows].reshape(g, e, cap, d)                     # (G, E, C, D)
    buf = PS.hint(buf, "dp", "tp", None, None)                   # identity on local groups
    buf = buf.transpose(0, 1).reshape(e, g * cap, d)             # (E, G*C, D)
    h_g = torch.bmm(buf, wg.to(dt))
    h = h_g * torch.sigmoid(h_g) * torch.bmm(buf, wi.to(dt))
    y = torch.bmm(h, wo.to(dt))                                  # (E, G*C, D)
    y = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)

    out = xt.new_zeros(g * (tg + 1), d)
    out.index_add_(0, rows, y * w_of_slot.reshape(g * e * cap)[:, None])
    return out.reshape(g, tg + 1, d)[:, :tg]


def _grouped_on_shards(cfg: ModelConfig, xt: DTensor, weights) -> DTensor:
    """:func:`_grouped` on each rank's own groups of a DTensor xt (G sharded
    over the data axes, or replicated): the weights are gathered whole
    (FSDP), their gradients summed over the ranks whose groups differ."""
    xp = list(xt.placements)          # a list: one output's placements
    wp = [Replicate() for _ in xp]
    grad_wp = [Partial() if isinstance(pl, Shard) else Replicate() for pl in xp]
    fn = local_map(functools.partial(_grouped, cfg), out_placements=xp,
                   in_placements=(xp,) + (wp,) * len(weights),
                   in_grad_placements=(xp,) + (grad_wp,) * len(weights),
                   device_mesh=xt.device_mesh, redistribute_inputs=True)
    return fn(xt, *weights)


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  A DTensor x runs each rank's groups
    locally."""
    b, s, d = x.shape
    g = _n_groups(b * s)
    xt = PS.hint(x.reshape(g, b * s // g, d), "dp", None, None)
    weights = (p.router, p.wi, p.wg, p.wo)
    if isinstance(xt, DTensor):
        out = _grouped_on_shards(cfg, xt, weights)
    else:
        out = _grouped(cfg, xt, *weights)
    out = PS.hint(out, "dp", None, None)
    return out.reshape(b, s, d)
