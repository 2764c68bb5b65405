"""Device meshes over ``torch.distributed``.

The port of ``repro.launch.mesh``.  JAX drives every device of a mesh from
one process; ``torch.distributed`` runs one process per rank, each with
its own program (multi-controller).  A mesh here is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group that :func:`init_world` starts, and every function that
builds one is COLLECTIVE: each rank must call it, in the same order.

Device type and backend are explicit.  A mesh's device type defaults to
``"cuda"``; a caller asks for ``"cpu"``.  :func:`init_world` starts NCCL
for ``"cuda"`` and gloo for ``"cpu"``, or the backend the caller names
(gloo takes CUDA tensors too, staging them through the host: that is how
several ranks share one card, where NCCL refuses).  Nothing switches from
one backend to another by itself.

:func:`use_mesh` activates a mesh for the activation hints of
:mod:`repro_torch.models.pshard` (the counterpart of ``jax.set_mesh``).

``repro``'s ``request_host_devices`` (an XLA flag that splits the host into
N devices) has no meaning here: a world of N ranks is N processes, started
by the caller.  It is not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "init_world",
    "make_mesh",
    "make_production_mesh",
    "make_local_mesh",
    "make_shard_mesh",
    "host_device_count",
    "use_mesh",
    "current_mesh",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_world(rank: int, world_size: int, *, store=None, init_method: Optional[str] = None,
               device_type: str = "cuda", backend: Optional[str] = None) -> str:
    """Start the default process group for this rank: NCCL for ``"cuda"``,
    gloo for ``"cpu"``, or ``backend`` when given.  Rendezvous through
    ``store`` (e.g. a ``FileStore``) or ``init_method`` (e.g.
    ``tcp://localhost:<port>``).  Returns the backend."""
    if device_type not in _BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}")
    backend = backend or _BACKENDS[device_type]
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world_size)
    return backend


def _require_world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: call launch.mesh.init_world first")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the world
    (their product must equal the world size).  Collective."""
    _require_world()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks on ("data", "model"); (2, 16, 16) = 512 across two
    pods, with "pod" in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the world on ("data",) — tests and examples."""
    return make_mesh((_require_world(),), ("data",), device_type)


def host_device_count() -> int:
    """Ranks in the world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_shard_mesh(n_shards: int, axis: str = "shards",
                    device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A 1-D mesh over ranks ``0 .. n_shards - 1`` for the sharded
    provenance index's collective engine, or ``None`` without a process
    group or when the world has fewer ranks than ``n_shards``.  Collective
    over the whole world (ranks past ``n_shards`` take part in building
    the mesh, and are not in it)."""
    if n_shards < 1 or not dist.is_initialized() or dist.get_world_size() < n_shards:
        return None
    if dist.get_world_size() == n_shards:
        return init_device_mesh(device_type, (n_shards,), mesh_dim_names=(axis,))
    return DeviceMesh(device_type, torch.arange(n_shards), mesh_dim_names=(axis,))


_ACTIVE = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh :func:`use_mesh` activated in this thread, or ``None``."""
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """Activate ``mesh`` for the activation hints inside the block."""
    prev = current_mesh()
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev
