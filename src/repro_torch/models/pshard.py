"""Activation-sharding hints (logical names -> mesh axes).

The port of ``repro.models.pshard``.  Model code annotates activations
with LOGICAL axis names; a launcher installs a policy mapping them to mesh
axes (:func:`use_policy`) and activates a mesh
(:func:`repro_torch.launch.mesh.use_mesh`).  Without a policy, or without
an active mesh, every hint is the identity, so single-device runs are
untouched.

With both, :func:`hint` redistributes a ``DTensor`` to the placements the
policy resolves: ``Shard(d)`` on the mesh axes a dim's name maps to (each
axis guarded by divisibility, as ``launch.sharding._guard``), ``Replicate``
on every other mesh axis (a dim named ``None`` is replicated, as in
``jax.lax.with_sharding_constraint``).  A plain tensor is the identity:
inside a region that runs on local shards (the MoE's per-group dispatch)
the data is already where the policy put it.

The policy's other keys are read by the models: ``"moe_groups"`` sets the
MoE's group count, ``"sp"`` turns on the sequence-parallel residual hint.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import current_mesh

__all__ = ["set_policy", "policy", "hint", "use_policy"]

_STATE = threading.local()

Axes = Union[None, str, Tuple[str, ...]]


def set_policy(mapping: Optional[Dict[str, Axes]]) -> None:
    """mapping: logical name ('dp', 'tp', ...) -> mesh axis/axes."""
    _STATE.policy = mapping


def policy() -> Optional[Dict[str, Axes]]:
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def use_policy(mapping: Optional[Dict[str, Axes]]) -> Iterator[None]:
    prev = policy()
    set_policy(mapping)
    try:
        yield
    finally:
        set_policy(prev)


def hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s placement, one logical name (or ``None``) per dim."""
    pol = policy()
    if pol is None:
        return x
    mesh = current_mesh()
    if mesh is None:                 # policy set but no mesh (local runs)
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"hint: {len(logical)} names for rank-{x.ndim} array")
    if not isinstance(x, DTensor):
        return x
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    placements = [Replicate()] * len(names)
    for dim, name in enumerate(logical):
        ax = pol.get(name) if name else None
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        # divisibility guard mirrors launch.sharding._guard
        size = math.prod(sizes[a] for a in axes)
        if size <= 1 or x.shape[dim] % size != 0:
            continue
        for a in axes:
            placements[names.index(a)] = Shard(dim)
    return x.redistribute(mesh, placements)
