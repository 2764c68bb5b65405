"""Tensor-parallel regions: a sublayer of a sharded model run on each
rank's own rows and its share of the heads, FFN columns, experts or SSD
channels.

A model whose activations are DTensors (a step on a mesh, placed by
:mod:`repro_torch.launch.sharding`) runs each sublayer — a norm and its
attention, MLP, MoE or SSD mixer, or the head — as one ``local_map``
region (:func:`region`).  Inside, the plain function of the sublayer runs
on local tensors, with the weights split over the policy's tensor-parallel
("tp") mesh axis on the dims the caller names and gathered whole over
every other axis (FSDP), and the rows of x as the data axes split them.
The region's result is a partial sum over "tp" (each rank adds its heads,
columns or experts), which :func:`region` reduces back to x's placements,
the all-reduce (or, for a sequence-parallel x, the reduce-scatter) of the
Megatron layout.  A weight's gradient is summed over the ranks whose rows
differ, and over the tp ranks for a weight each of them used whole.

Without a "tp" axis of more than one rank (no policy, the ``dp_only``
layout, a (1, 1) mesh) nothing is split over it: every weight is whole and
the region's result replicated.

Collectives inside a region (an SSD's gated norm over its split channels,
its projection's columns) go through :func:`all_reduce` and
:func:`all_gather`, whose gradients are what a partial-sum region needs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import pshard as PS

__all__ = ["Axes", "axes", "mesh_axis", "rows", "partial", "region", "all_reduce",
           "all_reduce_max", "all_gather"]


@dataclasses.dataclass(frozen=True)
class Axes:
    """A DTensor's mesh and its tensor-parallel axis: the mesh dim ``tp``
    (None when there is none of more than one rank), its size ``n``, this
    rank's coordinate ``rank`` on it and its process ``group``."""

    mesh: Any
    tp: Optional[int]
    n: int = 1
    rank: int = 0
    group: Any = None


def axes(x: DTensor) -> Axes:
    mesh = x.device_mesh
    name = (PS.policy() or {}).get("tp")
    names = list(mesh.mesh_dim_names or ())
    if isinstance(name, str) and name in names:
        return mesh_axis(mesh, names.index(name))
    return Axes(mesh, None)


def mesh_axis(mesh, dim: int) -> Axes:
    """Mesh dim ``dim`` as the axis a region splits over."""
    if mesh.size(dim) == 1:
        return Axes(mesh, None)
    return Axes(mesh, dim, mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim))


def rows(t: DTensor, ax: Axes, on_tp=None) -> Tuple[Any, ...]:
    """``t``'s row placements: ``Shard(0)`` on every mesh dim but "tp" that
    splits its first dim, ``on_tp`` (default ``Replicate()``) on "tp",
    ``Replicate()`` elsewhere."""
    return tuple((on_tp or Replicate()) if i == ax.tp else
                 (Shard(0) if p.is_shard(0) else Replicate())
                 for i, p in enumerate(t.placements))


def _split(ax: Axes, dim: Optional[int]) -> Tuple[Any, ...]:
    return tuple(Shard(dim) if (i == ax.tp and dim is not None) else Replicate()
                 for i in range(ax.mesh.ndim))


def _grad(ax: Axes, xrows, dim: Optional[int], split: bool) -> Tuple[Any, ...]:
    out = []
    for i, p in enumerate(xrows):
        if i == ax.tp:
            out.append(Shard(dim) if dim is not None else Partial() if split else Replicate())
        else:
            out.append(Partial() if p.is_shard() else Replicate())
    return tuple(out)


def partial(x: DTensor, ax: Axes, split: bool) -> Tuple[Any, ...]:
    """x's rows with a partial sum over "tp" (replicated there unless
    ``split``): the placements of a region's sublayer output."""
    return rows(x, ax, Partial() if split and ax.tp is not None else None)


def region(fn: Callable, x: DTensor, weights: Sequence[torch.Tensor],
           dims: Sequence[Optional[int]], *, split: bool,
           extra: Sequence[Any] = (), extra_placements: Optional[Sequence[Any]] = None,
           extra_grads: Optional[Sequence[Any]] = None, outs: Optional[Sequence[Any]] = None):
    """``fn(x, *weights, *extra)`` on local tensors of each rank.

    ``dims[i]``: the dim of ``weights[i]`` split over "tp" (None: whole).
    ``split``: whether the work is split over "tp" at all; when False every
    weight is whole there and the result is replicated.  ``extra``: further
    inputs, plain tensors (placement None) or DTensors placed as
    ``extra_placements`` says (a gradient comes back placed as
    ``extra_grads`` says, default the same).
    ``outs``: the placements of ``fn``'s outputs (a tuple of them for
    several), returned as they are; by default ``fn`` has one output, the
    sublayer's partial sum (:func:`partial`), returned reduced to x's own
    placements."""
    ax = axes(x)
    split = split and ax.tp is not None
    xr = rows(x, ax)
    w_in = tuple(_split(ax, d if split else None) for d in dims)
    w_grad = tuple(_grad(ax, xr, d if split else None, split) for d in dims)
    e_in = tuple(extra_placements or (None,) * len(extra))
    # one output's placements go as a list, several as a tuple of them
    single = outs is None or not isinstance(outs[0], (tuple, list))
    out_pl = list(partial(x, ax, split) if outs is None else outs) if single else tuple(outs)
    f = local_map(fn, out_placements=out_pl,
                  in_placements=(xr,) + w_in + e_in,
                  in_grad_placements=(partial(x, ax, split),) + w_grad
                  + tuple(extra_grads or e_in),
                  device_mesh=ax.mesh, redistribute_inputs=True)
    res = f(x, *weights, *extra)
    return res.redistribute(ax.mesh, x.placements) if outs is None else res


# ---------------------------------------------------------------------------
# Collectives inside a region
# ---------------------------------------------------------------------------
class _AllReduce(torch.autograd.Function):
    """The sum over ``group``.  In a region whose output is a partial sum,
    each rank's share of the loss depends on the sum, so the gradient is
    summed the same way; in one whose output is replicated, every rank
    holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, group, partial_out):
        ctx.group, ctx.partial_out = group, partial_out
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        if not ctx.partial_out:
            return g, None, None
        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated on the last dim; the gradient of a
    rank's piece is the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = funcol.wait_tensor(funcol.all_gather_tensor(x.movedim(-1, 0).contiguous(), 0,
                                                          group))
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(-1, 0).contiguous()
        out = funcol.wait_tensor(funcol.reduce_scatter_tensor(g, "sum", 0, ctx.group))
        return out.movedim(0, -1), None


def all_reduce(x: torch.Tensor, ax: Axes, partial_out: bool = True) -> torch.Tensor:
    """The sum of ``x`` over the tp ranks (``x`` itself without any), in a
    region whose output is a partial sum over them (``partial_out``) or
    replicated."""
    return x if ax.tp is None else _AllReduce.apply(x, ax.group, partial_out)


def all_reduce_max(x: torch.Tensor, ax: Axes) -> torch.Tensor:
    """The largest ``x`` over the tp ranks, without a gradient."""
    if ax.tp is None:
        return x.detach()
    return funcol.wait_tensor(funcol.all_reduce(x.detach().contiguous(), "max", ax.group))


def all_gather(x: torch.Tensor, ax: Axes) -> torch.Tensor:
    """The tp ranks' ``x`` concatenated on the last dim, in rank order."""
    return x if ax.tp is None else _AllGather.apply(x, ax.group)
