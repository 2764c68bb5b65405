"""Mesh-sharded relations: composition, audits and frontiers over a
``DeviceMesh``.

The port of ``repro.core.distributed``.  A relation R (n_src x n_dst bits,
packed little-endian into (n_src, ceil(n_dst/32)) int32 words) is sharded
by SOURCE ROWS over the mesh's ("pod", "data") axes, pod-major, its rows
padded with zeros to the shard multiple:

* composition (R1 · R2, :func:`compose_sharded`) is a LOCAL boolean
  product per rank: R1's row shard against the whole of R2, which each
  rank all-gathers in its packed int32 words (32x fewer bytes than the
  boolean operand).  The local product is ``kernels.ops.bitmatmul``: the
  hand-written ``csrc/bitmatmul.cu`` on the card, its plain version on the
  CPU;
* the dataset-level audit (:func:`lineage_audit_sharded`) is an AND, the
  SWAR popcount of ``kernels.ref.popcount32``, a one-hot sum per group,
  then one int32 SUM all-reduce: a vector of counts crosses the ranks,
  never records;
* the backward frontier (:func:`backward_frontier_sharded`) is local: its
  mask is row-aligned with the shard (owner computes), no collective.

The functions take the mesh from their DTensor operands (the reference
passes it beside jax arrays); plain tensors compute locally.

The collectives are ``torch.distributed``'s own (``all_gather_into_tensor``,
``all_reduce``) over the mesh's per-axis groups: they run on NCCL and on
gloo with CUDA tensors alike (DTensor's functional all-gather does not run
on gloo with CUDA tensors in torch 2.11).

Multi-controller: every rank runs the same program.  :func:`shard_relation`
takes the whole relation on every rank (each keeps its own rows, no
communication); :func:`compose_sharded` and :func:`lineage_audit_sharded`
are COLLECTIVE over the mesh, so every rank calls them in the same order.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as kref

__all__ = [
    "shard_relation",
    "gather_rows",
    "compose_sharded",
    "lineage_audit_sharded",
    "backward_frontier_sharded",
]


def _data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The axes provenance rows shard over: ('pod', 'data') where present."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _placements(mesh: DeviceMesh, on_data):
    axes = _data_axes(mesh)
    return [on_data if a in axes else Replicate() for a in mesh.mesh_dim_names]


def shard_relation(bits: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """A packed (rows, words) relation, or any row-aligned tensor (a group
    column), with its rows sharded over the data axes, padded with zeros up
    to the shard multiple.  Every rank passes the whole tensor and keeps
    its own rows."""
    axes = _data_axes(mesh)
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    n_shards = math.prod(sizes[a] for a in axes)
    pad = (-bits.shape[0]) % n_shards
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,) + tuple(bits.shape[1:]))])
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    shard = 0                       # pod-major index of this rank's row block
    for a in axes:
        shard = shard * sizes[a] + coord[names.index(a)]
    rows = bits.shape[0] // n_shards
    local = bits[shard * rows:(shard + 1) * rows].contiguous()
    return DTensor.from_local(local, mesh, _placements(mesh, Shard(0)), run_check=False)


def _local(x) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def gather_rows(x: DTensor) -> torch.Tensor:
    """The whole of a DTensor row-sharded by :func:`shard_relation` (its
    padding rows included), on every rank.  Collective."""
    return _gather_rows(x.to_local(), x.device_mesh)


def _gather_rows(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole of a tensor row-sharded over the data axes, pod-major:
    one ``all_gather_into_tensor`` per data axis, the innermost first."""
    for axis in reversed(_data_axes(mesh)):
        group = mesh.get_group(axis)
        out = local.new_empty((dist.get_world_size(group) * local.shape[0],) + local.shape[1:])
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        local = out
    return local


def _sum_over_data(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` summed over the data axes, in place (one all-reduce each)."""
    for axis in _data_axes(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def _bitmm(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(OR, AND) product of packed operands through ``ops.bitmatmul``; B's
    rows past A's packed columns are padding (zeros) and are dropped."""
    kw = a_bits.shape[1]
    return K.bitmatmul(a_bits, b_bits[:kw * 32])


def compose_sharded(a_bits, b_bits):
    """C = A·B over the (OR, AND) semiring; A and B row-sharded DTensors
    (:func:`shard_relation`), B's rows being A's contraction dim.  Each rank
    all-gathers B's packed words, then multiplies its own rows of A by the
    whole of B.  C keeps A's row sharding.  Plain tensors (or a mesh with
    no data axis) compose locally.  Collective."""
    if not isinstance(a_bits, DTensor) or not _data_axes(a_bits.device_mesh):
        return _bitmm(_local(a_bits), _local(b_bits))
    mesh = a_bits.device_mesh
    c = _bitmm(a_bits.to_local(), _gather_rows(b_bits.to_local(), mesh))
    return DTensor.from_local(c, mesh, a_bits.placements, run_check=False)


def _hits(rel: torch.Tensor, mask_words: torch.Tensor) -> torch.Tensor:
    """Rows of ``rel`` with any bit set under ``mask_words``."""
    return kref.popcount32(rel & mask_words[None, :]).sum(dim=1) > 0


def lineage_audit_sharded(rel_bits, group, dst_mask_words: torch.Tensor,
                          n_groups: int) -> torch.Tensor:
    """The paper's dataset-level audit: for each source-row group g, the
    number of source rows of group g that reach ANY output row selected by
    the packed ``dst_mask_words`` (replicated):

        hits[i] = OR_w popcount(rel[i, w] & dst_mask[w]) > 0
        out[g]  = sum_i hits[i] * [group[i] == g]

    ``rel_bits`` and ``group`` (int32, row-aligned) sharded alike
    (:func:`shard_relation`), or plain.  Returns the (n_groups,) int32
    counts, the same on every rank (one SUM all-reduce).  Collective."""
    local = _local(rel_bits)
    grp = _local(group).long()
    hit = _hits(local, dst_mask_words).to(torch.int32)
    counts = (hit[:, None] * F.one_hot(grp, n_groups).to(torch.int32)).sum(dim=0,
                                                                          dtype=torch.int32)
    if not isinstance(rel_bits, DTensor):
        return counts
    return _sum_over_data(counts, rel_bits.device_mesh)


def backward_frontier_sharded(rel_bits, dst_mask_words: torch.Tensor):
    """Backward record lineage at dataset scale: which SOURCE rows reach any
    selected output row.  Local AND + popcount per shard: the bool mask is
    a DTensor row-aligned with ``rel_bits`` (or plain for plain input), no
    collective."""
    hit = _hits(_local(rel_bits), dst_mask_words)
    if not isinstance(rel_bits, DTensor):
        return hit
    return DTensor.from_local(hit, rel_bits.device_mesh, rel_bits.placements, run_check=False)
