"""Partition rules: the FSDP x TP layout of every parameter, batch and cache
leaf, and its DTensor placements.

The port of ``repro.launch.sharding``, split in two:

* the RULES (:func:`param_pspecs`, :func:`batch_pspecs`,
  :func:`cache_pspecs`, :func:`state_pspecs` and what they use) take a
  plain mesh shape — a mapping of axis names to sizes in mesh order, or a
  ``DeviceMesh`` — and need no process group.  A spec is a tuple with one
  entry per tensor dim: ``None``, an axis name, or a tuple of axis names,
  as the reference's ``PartitionSpec``;
* :func:`to_placements` turns a spec into DTensor placements on a
  ``DeviceMesh`` (``Shard(d)`` or ``Replicate()`` per mesh dim),
  :func:`to_shardings` maps a whole tree, and :func:`place` distributes a
  tree of tensors by such a tree.

Each rule resolves per mesh with a DIVISIBILITY GUARD: a dim is sharded
only if its size divides the product of the proposed axes (whisper's
vocab 51865 is not 16-divisible, so the vocab dim of its embedding is
replicated while the d_model dim still FSDPs).

Layout (fsdp = ("pod", "data") where present, tp = "model"):

  embed        (V, D)        -> (tp, fsdp)
  lm_head      (D, V)        -> (fsdp, tp)
  attn wq/wk/wv(D, H*hd)     -> (fsdp, tp)
  attn wo      (H*hd, D)     -> (tp, fsdp)
  mlp wi/wg    (D, F)        -> (fsdp, tp)
  mlp wo       (F, D)        -> (tp, fsdp)
  moe router   (D, E)        -> (fsdp, None)
  moe wi/wg    (E, D, F)     -> (tp, fsdp, None)   expert-parallel
  moe wo       (E, F, D)     -> (tp, None, fsdp)
  ssd in_proj  (D, X)        -> (fsdp, tp)
  ssd out_proj (di, D)       -> (tp, fsdp)
  ssd conv     (k, Cd)       -> (None, tp)
  norms/scalars              -> replicated

The port's parameters are per layer (``layers.{i}.attn.wq``) where the
reference stacks a block's layers on a leading axis
(``blocks/l{i}/attn/wq``): a port name is mapped to the reference's path
(:func:`~repro_torch.models.carry.reference_path`) and the same rule is
applied to the per-layer shape, without the reference's leading ``None``.

Batches: tokens/labels (B, S) -> (dp, None) when B divides; frames
(B, T, D) -> (dp, None, None).  Caches: batch over dp when divisible; KV
heads over tp when divisible, else SEQUENCE over tp; batch-1 long-context
cells shard the sequence over (data, model) jointly.

Two tensor dims sharded over several mesh axes split pod-major, as JAX's
``NamedSharding`` does: DTensor applies ``Shard(d)`` placements in mesh-dim
order, the first mesh dim outermost.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.carry import reference_path
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree
from repro_torch.train.optimizer import OptState
from repro_torch.train.trainer import TrainState

__all__ = [
    "fsdp_axes", "tp_axis", "layout_axes", "param_pspecs", "batch_pspecs", "cache_pspecs",
    "state_pspecs", "to_placements", "to_shardings", "place", "Sharding",
]

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
MeshShape = Union[Mapping[str, int], DeviceMesh]


def _shape(mesh: MeshShape) -> Dict[str, int]:
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def fsdp_axes(mesh: MeshShape) -> Tuple[str, ...]:
    names = _shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh: MeshShape) -> Optional[str]:
    return "model" if "model" in _shape(mesh) else None


def layout_axes(mesh: MeshShape, layout: str = "fsdp_tp"):
    """(fsdp_axes, tp_axis) for a named layout.

    fsdp_tp  — FSDP over (pod, data) x tensor-parallel over model (default).
    dp_only  — pure data parallelism over EVERY axis, no TP.
    """
    if layout == "dp_only":
        return tuple(_shape(mesh)), None
    return fsdp_axes(mesh), tp_axis(mesh)


def _axes_size(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = _shape(mesh)
    return math.prod(shape[a] for a in axes)


def _spec(entries) -> Spec:
    """A spec as ``PartitionSpec`` normalises it: a one-axis tuple is the
    axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _guard(mesh: MeshShape, size: int, axes):
    """axes if size divides their product, else None (replicate)."""
    if axes is None:
        return None
    n = _axes_size(mesh, axes)
    return axes if (n > 1 and size % n == 0) else None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _param_rule(mesh: MeshShape, path: str, shape: Tuple[int, ...],
                layout: str = "fsdp_tp") -> Spec:
    """The spec of one parameter of per-layer ``shape`` at the reference's
    ``path`` (``/``-joined)."""
    fs, tp = layout_axes(mesh, layout)
    fs = fs or None
    name = path.rsplit("/", 1)[-1]

    def spec(*dims) -> Spec:
        return _spec(_guard(mesh, shape[i], d) for i, d in enumerate(dims))

    if len(shape) <= 1:
        return (None,) * len(shape)

    if name == "embed":
        return spec(tp, fs)
    if name == "lm_head":
        return spec(fs, tp)
    if "moe" in path:
        if name == "router":
            return spec(fs, None)
        if name in ("wi", "wg"):
            return spec(tp, fs, None)
        if name == "wo":
            return spec(tp, None, fs)
    if "mlp" in path or "attn" in path or "cross" in path:
        if name in ("wi", "wg", "wq", "wk", "wv"):
            return spec(fs, tp)
        if name == "wo":
            return spec(tp, fs)
    if "ssd" in path:
        if name == "in_proj":
            return spec(fs, tp)
        if name == "out_proj":
            return spec(tp, fs)
        if name == "conv_w":
            return spec(None, tp)
    # fallback: FSDP the largest dim (the first of equals, as np.argmax)
    dims: List[Entry] = [None] * len(shape)
    big = max(range(len(shape)), key=lambda i: (shape[i], -i))
    dims[big] = _guard(mesh, shape[big], fs)
    return _spec(dims)


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def param_pspecs(cfg: ModelConfig, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 mesh: MeshShape, layout: str = "fsdp_tp") -> Dict[str, Spec]:
    """``{port parameter name: spec}`` for a model (or tensors keyed by its
    parameter names, e.g. a moment), of any device (``meta`` included)."""
    return {n: _param_rule(mesh, "/".join(reference_path(cfg, n)[0]), tuple(t.shape), layout)
            for n, t in _named(params).items()}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------
def batch_pspecs(shapes: Mapping[str, torch.Tensor], mesh: MeshShape,
                 layout: str = "fsdp_tp") -> Dict[str, Spec]:
    dp = (tuple(_shape(mesh)) if layout == "dp_only" else fsdp_axes(mesh)) or None

    def rule(leaf) -> Spec:
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        return _spec((_guard(mesh, shape[0], dp),) + (None,) * (len(shape) - 1))

    return {k: rule(v) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------
_CACHE_RANK = {"k": 4, "v": 4, "ck": 4, "cv": 4, "state": 4, "conv": 3}


def _cache_rule(mesh: MeshShape, path: str, shape: Tuple[int, ...]) -> Spec:
    dp = fsdp_axes(mesh) or None
    tp = tp_axis(mesh)
    name = path.rsplit("/", 1)[-1]
    # a leading layer axis above the core rank (the reference's stacked
    # caches; the port's per-layer caches have none)
    core_rank = _CACHE_RANK.get(name, len(shape))
    stacked = len(shape) == core_rank + 1
    core = shape[1:] if stacked else shape

    def wrap(resolved) -> Spec:
        return _spec(([None] + resolved) if stacked else resolved)

    if name in ("k", "v", "ck", "cv"):
        b, s, kv, hd = core
        bax = _guard(mesh, b, dp)
        if bax is None and _guard(mesh, s, dp + (tp,) if (dp and tp) else tp) is not None:
            # batch-1 long-context: sequence over (data, model) jointly
            joint = (dp + (tp,)) if dp else (tp,)
            return wrap([None, _guard(mesh, s, joint), None, None])
        if _guard(mesh, kv, tp) is not None:
            return wrap([bax, None, tp, None])
        return wrap([bax, _guard(mesh, s, tp), None, None])
    if name == "state":                      # SSD (B, H, P, N)
        b, h, p_, n = core
        return wrap([_guard(mesh, b, dp), _guard(mesh, h, tp), None, None])
    if name == "conv":                       # (B, k-1, Cd)
        b, k_, cd = core
        return wrap([_guard(mesh, b, dp), None, _guard(mesh, cd, tp)])
    return (None,) * len(shape)


def cache_pspecs(cache: Sequence[Mapping[str, torch.Tensor]],
                 mesh: MeshShape) -> List[Dict[str, Spec]]:
    """One dict of specs per layer of the port's cache."""
    return [{k: _cache_rule(mesh, k, tuple(v.shape)) for k, v in lc.items()} for lc in cache]


# ---------------------------------------------------------------------------
# TrainState (params + optimizer) — moments mirror the param layout
# ---------------------------------------------------------------------------
def state_pspecs(cfg: ModelConfig, state: TrainState, mesh: MeshShape,
                 layout: str = "fsdp_tp") -> TrainState:
    pspecs = param_pspecs(cfg, state.params, mesh, layout)
    err = None if state.opt.err is None else param_pspecs(cfg, state.opt.err, mesh, layout)
    return TrainState(params=pspecs, opt=OptState(step=(), mu=pspecs, nu=pspecs, err=err))


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sharding:
    """A ``DeviceMesh`` and one placement per mesh dim (``NamedSharding``'s
    counterpart)."""

    mesh: DeviceMesh
    placements: Tuple[Any, ...]


def to_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """``Shard(d)`` on every mesh dim named by tensor dim ``d``'s entry,
    ``Replicate()`` on the rest.  An entry naming several mesh axes must
    name them in mesh order (pod-major), the order DTensor splits in."""
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) if a in names else None for a in axes]
        if None in pos:
            raise ValueError(f"spec {spec}: axes {axes} not all in mesh {names}")
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {axes} not in mesh order {names}")
        for i in pos:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(a, str) for a in e)) for e in x)


def to_shardings(specs: Any, mesh: DeviceMesh) -> Any:
    """A tree of specs (dicts, lists, NamedTuples) as a tree of
    :class:`Sharding` on ``mesh``."""
    if specs is None:
        return None
    if _is_spec(specs):
        return Sharding(mesh, to_placements(specs, mesh))
    if hasattr(specs, "_fields"):
        return type(specs)(*(to_shardings(v, mesh) for v in specs))
    if isinstance(specs, Mapping):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [to_shardings(v, mesh) for v in specs]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` (a ``TrainState``, mapping, module or tensor, as
    :func:`~repro_torch.train.checkpoint.flatten_tree` walks) with every
    leaf distributed by the :class:`Sharding` at its path (a module's
    parameters keep their ``requires_grad``).  Every rank passes the whole
    tree, the same on each, and keeps its own shards: no communication."""
    sh = dict(flatten_tree(shardings, is_leaf=lambda x: isinstance(x, Sharding)))
    leaves = {}
    for key, t in flatten_tree(tree):
        if key not in sh:
            raise KeyError(f"no sharding for leaf {key!r}")
        leaves[key] = distribute_tensor(t.detach(), sh[key].mesh, sh[key].placements,
                                        src_data_rank=None)
    return unflatten_tree(tree, leaves)
