"""Row-range-sharded provenance index, on one device.

One :class:`~repro_torch.core.pipeline.ProvenanceIndex` holds the whole
pipeline's provenance.  This module partitions that index into ``S``
shards by CONTIGUOUS OUTPUT-ROW RANGE — the same
:func:`~repro_torch.core.provtensor.shard_ranges` layout for every
dataset, every op tensor, and every composed hop-cache relation — and runs
the batched mask walkers as per-shard work joined two ways:

* **forward hop** — probe masks are replicated (``(B, n_in)`` is the small
  side); each shard propagates through its row-sliced tensor
  (:meth:`~repro_torch.core.provtensor.ProvTensor.slice_rows`) producing the
  ``(B, hi-lo)`` slice of the output mask; the full stack is the
  range-ordered CONCATENATION over shards.
* **backward hop** — each shard scatters its local ``(B, hi-lo)`` output
  slice to the full input space; the answer is the OR over shards.

Because the OR over the shard contributions IS the full relation, both
joins are byte-identical to the merged walk.

Two engines share that contract:

* ``"collective"`` — one shard per rank of a 1-D ``DeviceMesh``
  (:func:`~repro_torch.launch.mesh.make_shard_mesh`), joined by
  ``torch.distributed`` collectives: a forward hop is a per-rank gather
  and scatter, then ``all_gather``; a backward hop a scatter into the full
  input space, then an int32 SUM ``all_reduce`` and ``> 0`` (the
  reference's ``psum(...) > 0``; NCCL has no bitwise-OR reduction);
* the sequential engine (``repro``'s ``"numpy"``) — a loop over the shards
  with torch ops on the view's device, and the same join algebra.

``engine="auto"`` picks the collective engine when a process group is up,
the world holds ``n_shards`` ranks and this rank is one of the first
``n_shards``; otherwise the sequential one.  ``"collective"`` raises
without such a world.

Multi-controller: every rank of the mesh runs the same program.  Building
the view with ``"auto"`` or ``"collective"`` (it builds the mesh) and every
mask hop of the collective engine are COLLECTIVE: each rank must build the
same index from the same seed and issue the same queries in the same
order, so the memoised pair blocks and the session's routes are the same
on every rank.  A hop some ranks skip hangs the others.

:class:`ShardedProvenanceIndex` is a VIEW over the base index — datasets,
DAG structure and attribute maps are shared; only the per-op tensors are
re-dressed as :class:`ShardedTensor`.  The port's
:class:`~repro_torch.provenance.session.QuerySession` therefore runs every
plan kind over the view unchanged (a linear chain on a CUDA view goes to
the fused ``batched_walk`` kernel through the delegated bitplanes), and
:class:`ShardedComposedIndex` gives it a hop-cache whose entries are
per-shard relation BLOCKS (``(n_src, hi-lo)`` each), with the per-shard
storage backend chosen from SHARD-LOCAL nnz
(:meth:`~repro_torch.core.costmodel.RelStats.from_slot_range`).

Federation seam — :meth:`ShardedProvenanceIndex.as_catalog` registers each
shard as a :class:`~repro_torch.provenance.catalog.ProvCatalog` member
holding its composed ``src → dst`` block as ONE recorded op, stitched by
range-alignment links into a full-width gather member.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.compose import (
    chain_gather,
    compose_pair_csr,
    csr_from_pairs,
    csr_pairs,
    op_csr,
    path_tensors,
)
from repro_torch.core.costmodel import (
    DENSITY_THRESHOLD,
    CostModel,
    RelStats,
    compose_est,
)
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import (
    CSR,
    ProvTensor,
    pack_bitplane,
    shard_ranges,
    unpack_bitplane,
)
from repro_torch.kernels import ops as K

__all__ = [
    "ShardedTensor",
    "ShardedProvenanceIndex",
    "ShardedComposedIndex",
]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _bool_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean (OR, AND) product of bool ``a`` (M, K) and ``b`` (K, N) ->
    bool (M, N), through ``ops.bitmatmul`` on packed planes: exact integer
    words, 1 bit a cell, and the hand kernel on a CUDA operand."""
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or k == 0 or n == 0:
        return torch.zeros((m, n), dtype=torch.bool, device=a.device)
    return unpack_bitplane(K.bitmatmul(pack_bitplane(a), pack_bitplane(b)), n)


# ---------------------------------------------------------------------------
# The collective engine
# ---------------------------------------------------------------------------
class _CollectiveEngine:
    """Batched mask hops as ``torch.distributed`` collectives over a 1-D
    mesh, one shard per rank.

    Per (tensor, slot) the valid link pairs of every shard pad to one
    ``(S, L)`` block (the collectives need equal sizes), memoised on the
    tensor; a rank reads its own row.  Masks travel as uint8."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()

    def _padded(self, st: "ShardedTensor", inp: int):
        """(out_idx, in_idx) int64 and valid bool ``(S, L)`` blocks on the
        view's device, the shard widths and the padded width."""
        cache = st._collective
        if inp not in cache:
            pairs = []
            for shard in st.shards:
                out, inn = shard._slot_pairs(inp)
                keep = (out >= 0) & (inn >= 0)
                pairs.append((out[keep].long(), inn[keep].long()))
            S = len(pairs)
            L = max(1, max(len(o) for o, _ in pairs))
            dev = st.device
            out_idx = torch.zeros((S, L), dtype=torch.int64, device=dev)
            in_idx = torch.zeros((S, L), dtype=torch.int64, device=dev)
            valid = torch.zeros((S, L), dtype=torch.bool, device=dev)
            for s, (o, i) in enumerate(pairs):
                out_idx[s, :len(o)] = o
                in_idx[s, :len(o)] = i
                valid[s, :len(o)] = True
            widths = [hi - lo for lo, hi in st.ranges]
            cache[inp] = (out_idx, in_idx, valid, widths, max(max(widths), 1))
        return cache[inp]

    def forward(self, st: "ShardedTensor", inp: int, masks: torch.Tensor) -> torch.Tensor:
        out_idx, in_idx, valid, widths, pw = self._padded(st, inp)
        o, i, v = out_idx[self.rank], in_idx[self.rank], valid[self.rank]
        vals = (masks[:, i] & v[None, :]).to(torch.int32)
        loc = torch.zeros((masks.shape[0], pw), dtype=torch.int32, device=masks.device)
        loc = (loc.index_add_(1, o, vals) > 0).to(torch.uint8)
        gathered = [torch.empty_like(loc) for _ in widths]
        dist.all_gather(gathered, loc, group=self.group)
        return torch.cat([g[:, :w] for g, w in zip(gathered, widths)], dim=1).to(torch.bool)

    def backward(self, st: "ShardedTensor", inp: int, masks: torch.Tensor) -> torch.Tensor:
        out_idx, in_idx, valid, _, pw = self._padded(st, inp)
        lo, hi = st.ranges[self.rank]
        o, i, v = out_idx[self.rank], in_idx[self.rank], valid[self.rank]
        local = torch.zeros((masks.shape[0], pw), dtype=torch.bool, device=masks.device)
        local[:, :hi - lo] = masks[:, lo:hi]
        vals = (local[:, o] & v[None, :]).to(torch.int32)
        contrib = torch.zeros((masks.shape[0], st.n_in[inp]), dtype=torch.int32,
                              device=masks.device)
        contrib = (contrib.index_add_(1, i, vals) > 0).to(torch.int32)
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=self.group)
        return contrib > 0


# ---------------------------------------------------------------------------
# Row-range-sharded tensors and the op/index views over them
# ---------------------------------------------------------------------------
class ShardedTensor:
    """One op tensor partitioned into row-range shards, answering the full
    :class:`ProvTensor` mask surface through the shard join algebra.
    Slot statistics and lazy mirrors delegate to the base tensor (they
    describe the SAME relation)."""

    def __init__(self, base: ProvTensor, n_shards: int,
                 engine: Optional[_CollectiveEngine] = None) -> None:
        self.base = base
        self.n_shards = int(n_shards)
        self.ranges = shard_ranges(base.n_out, n_shards)
        self.shards = [base.slice_rows(lo, hi) for lo, hi in self.ranges]
        self.engine = engine
        self._collective: Dict = {}      # the engine's pair blocks, by slot

    # -- delegated shape / statistics / mirrors ------------------------------
    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def n_out(self) -> int:
        return self.base.n_out

    @property
    def n_in(self) -> tuple:
        return self.base.n_in

    @property
    def k(self) -> int:
        return self.base.k

    @property
    def structured(self) -> bool:
        return self.base.structured

    @property
    def nnz(self) -> int:
        return self.base.nnz

    @property
    def coo(self) -> torch.Tensor:
        return self.base.coo

    def resident(self) -> "ShardedTensor":
        """The base tensor faulted back if a spill tier holds it; the
        shards were sliced from it at construction."""
        self.base.resident()
        return self

    def slot_structure(self, inp: int):
        return self.base.slot_structure(inp)

    def slot_gather(self, inp: int):
        return self.base.slot_gather(inp)

    def slot_nnz(self, inp: int) -> int:
        return self.base.slot_nnz(inp)

    def slot_nnz_range(self, inp: int, lo: int, hi: int) -> int:
        return self.base.slot_nnz_range(inp, lo, hi)

    def slot_shape(self, inp: int) -> tuple:
        return self.base.slot_shape(inp)

    def slot_density(self, inp: int) -> float:
        return self.base.slot_density(inp)

    def _slot_pairs(self, inp: int):
        return self.base._slot_pairs(inp)

    def fwd(self, inp: int):
        return self.base.fwd(inp)

    def bwd(self, inp: int):
        return self.base.bwd(inp)

    def bitplane_fwd(self, inp: int) -> torch.Tensor:
        return self.base.bitplane_fwd(inp)

    def bitplane_bwd(self, inp: int) -> torch.Tensor:
        return self.base.bitplane_bwd(inp)

    def nbytes(self, include_index: bool = True) -> int:
        return self.base.nbytes(include_index)

    # -- the sharded mask hops ----------------------------------------------
    def forward_mask_batch(self, inp: int, in_masks: torch.Tensor) -> torch.Tensor:
        masks = in_masks.to(torch.bool)
        if self.engine is not None:
            return self.engine.forward(self, inp, masks)
        return torch.cat([t.forward_mask_batch(inp, masks) for t in self.shards], dim=1)

    def backward_mask_batch(self, inp: int, out_masks: torch.Tensor) -> torch.Tensor:
        masks = out_masks.to(torch.bool)
        if self.engine is not None:
            return self.engine.backward(self, inp, masks)
        out = torch.zeros((masks.shape[0], self.n_in[inp]), dtype=torch.bool,
                          device=masks.device)
        for (lo, hi), t in zip(self.ranges, self.shards):
            out |= t.backward_mask_batch(inp, masks[:, lo:hi])
        return out

    def forward_mask(self, inp: int, in_mask: torch.Tensor) -> torch.Tensor:
        return self.forward_mask_batch(inp, in_mask[None, :])[0]

    def backward_mask(self, inp: int, out_mask: torch.Tensor) -> torch.Tensor:
        return self.backward_mask_batch(inp, out_mask[None, :])[0]

    def forward_rows(self, inp: int, rows) -> torch.Tensor:
        pieces = [t.forward_rows(inp, rows) + lo
                  for (lo, _), t in zip(self.ranges, self.shards)]
        return torch.unique(torch.cat(pieces))

    def backward_rows(self, inp: int, rows) -> torch.Tensor:
        """Sorted-unique input rows; output rows index the FULL output
        space (negative ones wrap) and are routed to their shard."""
        if isinstance(rows, torch.Tensor) and rows.dtype == torch.bool:
            rows = torch.nonzero(rows).reshape(-1)
        rows = torch.as_tensor(rows if isinstance(rows, torch.Tensor) else list(rows),
                               dtype=torch.int64).to(self.device).reshape(-1)
        rows = torch.where(rows < 0, rows + self.n_out, rows)
        pieces = [t.backward_rows(inp, rows[(rows >= lo) & (rows < hi)] - lo)
                  for (lo, hi), t in zip(self.ranges, self.shards)]
        return torch.unique(torch.cat(pieces))

    def __repr__(self) -> str:
        return (f"ShardedTensor(n_out={self.n_out}, n_in={self.n_in}, "
                f"shards={self.n_shards}, "
                f"engine={'collective' if self.engine else 'sequential'})")


@dataclasses.dataclass
class _ShardedOp:
    """Op-record view: same identity/metadata, sharded tensor."""

    op_id: int
    info: object
    tensor: ShardedTensor
    input_ids: List[str]
    output_id: str


# ---------------------------------------------------------------------------
# The sharded hop-cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _ShardBlock:
    """One shard's ``(n_src, hi-lo)`` slice of a composed relation: torch
    sparse CSR (int32 indices, float32 ones) or a dense bool tensor."""

    kind: str               # "csr" | "dense"
    mat: torch.Tensor
    lo: int
    hi: int
    nnz: int

    def nbytes(self) -> int:
        if self.kind == "dense":
            return _nbytes(self.mat)
        return (_nbytes(self.mat.values()) + _nbytes(self.mat.col_indices())
                + _nbytes(self.mat.crow_indices()))

    def pairs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The block's (src row, shard-local dst row) int64 links."""
        if self.kind == "dense":
            return torch.nonzero(self.mat, as_tuple=True)
        return csr_pairs(self.mat)


@dataclasses.dataclass
class _ShardEntry:
    blocks: List[_ShardBlock]
    rows: int               # n_src
    cols: int               # n_dst
    nbytes: int


def _base_tensor(tensor) -> ProvTensor:
    return tensor.base if isinstance(tensor, ShardedTensor) else tensor


def _dense_rel(tensor: ProvTensor, slot: int) -> torch.Tensor:
    """Dense bool (n_in, n_out) relation of one slot (dense blocks only)."""
    out, inn = tensor._slot_pairs(slot)
    out, inn = out.to(torch.int64), inn.to(torch.int64)
    valid = (out >= 0) & (inn >= 0)
    dense = torch.zeros((tensor.n_in[slot], tensor.n_out), dtype=torch.bool,
                        device=tensor.device)
    dense[inn[valid], out[valid]] = True
    return dense


class ShardedComposedIndex:
    """Hop-cache over a :class:`ShardedProvenanceIndex`: each ``(src, dst)``
    relation is held as per-shard column blocks.

    Blocks compose RIGHT-TO-LEFT from the dst-row-sliced last hop, so every
    intermediate is ``(n_i, hi-lo)``.  The per-shard storage backend
    (sparse CSR vs dense bool) follows the cost model's SHARD-LOCAL density
    estimate (:meth:`RelStats.from_slot_range` folded through
    :func:`compose_est`); a fully structured chain is sliced from its
    closed-form gather with no product at all.  Dense products and dense
    probes run through ``ops.bitmatmul`` on packed planes; CSR products are
    torch sparse products settled to int32 indices and ones, so block bytes
    equal ``repro``'s scipy blocks.  Probes join like the walkers: forward
    concatenates block answers in range order, backward ORs them.

    Same planner surface as :class:`~repro_torch.core.hopcache.ComposedIndex`
    (``probe_forward`` / ``probe_backward`` / ``contains`` / ``residency``
    / ``memory_budget_bytes`` / ``costmodel`` / ``stats``), so
    ``QuerySession`` routes through it unchanged.
    """

    def __init__(self, sharded: "ShardedProvenanceIndex",
                 memory_budget_bytes: int = 64 << 20) -> None:
        self.sharded = sharded
        self.index = sharded          # planner surface parity (stats/name)
        self.device = sharded.device
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.costmodel = CostModel(sharded)
        self._cache: "OrderedDict[Tuple[str, str], _ShardEntry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- composition ---------------------------------------------------------
    def _shard_chain_est(self, chain, lo: int, hi: int) -> RelStats:
        """Estimated stats of the composed relation restricted to dst rows
        ``[lo, hi)``: shard-local stats for the final hop, full-slot stats
        folded in for the upstream hops."""
        last_op, last_slot = chain[-1]
        acc = RelStats.from_slot_range(last_op.tensor, last_slot, lo, hi)
        for op, slot in reversed(chain[:-1]):
            acc = compose_est(RelStats.from_slot(op.tensor, slot), acc)
        return acc

    def _compose_block(self, chain, n_src: int, lo: int, hi: int,
                       g: Optional[torch.Tensor]) -> _ShardBlock:
        width = hi - lo
        if g is not None:
            # fully structured chain: the closed-form dst -> src gather,
            # sliced to this shard's window — O(width) work, no product
            gs = g[lo:hi]
            dst_local = torch.nonzero(gs >= 0).reshape(-1)
            src_rows = gs[dst_local].to(torch.int64)
            mat = csr_from_pairs(src_rows, dst_local, n_src, width)
            return _ShardBlock("csr", mat, lo, hi, int(dst_local.numel()))
        est = self._shard_chain_est(chain, lo, hi)
        last_op, last_slot = chain[-1]
        sliced = _base_tensor(last_op.tensor).slice_rows(lo, hi)
        if est.density >= DENSITY_THRESHOLD:
            acc = _dense_rel(sliced, last_slot)
            for op, slot in reversed(chain[:-1]):
                acc = _bool_product(_dense_rel(_base_tensor(op.tensor), slot), acc)
            return _ShardBlock("dense", acc, lo, hi, int(torch.count_nonzero(acc)))
        acc = op_csr(sliced, last_slot)
        for op, slot in reversed(chain[:-1]):
            acc = compose_pair_csr(op_csr(_base_tensor(op.tensor), slot), acc)
        return _ShardBlock("csr", acc, lo, hi, int(acc.col_indices().numel()))

    def _entry(self, src: str, dst: str) -> Optional[_ShardEntry]:
        key = (src, dst)
        entry = self._cache.get(key)
        if entry is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return entry
        base = self.sharded.base
        if src not in base.datasets or dst not in base.datasets:
            raise KeyError(f"unknown dataset in relation {src!r} -> {dst!r}")
        self.misses += 1
        n_src = base.datasets[src].n_rows
        n_dst = base.datasets[dst].n_rows
        try:
            chain = path_tensors(base, src, dst)
        except KeyError:
            return None
        ranges = shard_ranges(n_dst, self.sharded.n_shards)
        if not chain:           # src == dst: identity, sliced per shard
            g = torch.arange(n_dst, dtype=torch.int32, device=self.device)
        else:
            g = chain_gather(chain)
        blocks = [self._compose_block(chain, n_src, lo, hi, g) for lo, hi in ranges]
        entry = _ShardEntry(blocks=blocks, rows=n_src, cols=n_dst,
                            nbytes=sum(b.nbytes() for b in blocks))
        self._cache[key] = entry
        self._bytes += entry.nbytes
        while self._bytes > self.memory_budget_bytes and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.nbytes
            self.evictions += 1
        return entry

    # -- planner surface -----------------------------------------------------
    def contains(self, src: str, dst: str) -> bool:
        return (src, dst) in self._cache

    def residency(self, src: str, dst: str) -> Optional[str]:
        """``"ram"`` when the relation's blocks are composed, else None (the
        sharded hop-cache has no spill tier)."""
        return "ram" if (src, dst) in self._cache else None

    def _stack(self, masks) -> torch.Tensor:
        return torch.atleast_2d(torch.as_tensor(masks).to(device=self.device,
                                                          dtype=torch.bool))

    def probe_forward(self, masks, src: str, dst: str) -> torch.Tensor:
        """(B, |src|) bool -> (B, |dst|): per-shard block probes concatenated
        in range order.  No path -> all-empty (the walkers' convention)."""
        masks = self._stack(masks)
        entry = self._entry(src, dst)
        if entry is None:
            return torch.zeros((masks.shape[0], self.sharded.base.datasets[dst].n_rows),
                               dtype=torch.bool, device=self.device)
        return torch.cat([self._block_forward(b, masks[:, : entry.rows])
                          for b in entry.blocks], dim=1)

    def probe_backward(self, masks, dst: str, src: str) -> torch.Tensor:
        """(B, |dst|) bool -> (B, |src|): per-shard block probes OR-reduced."""
        masks = self._stack(masks)
        entry = self._entry(src, dst)
        if entry is None:
            return torch.zeros((masks.shape[0], self.sharded.base.datasets[src].n_rows),
                               dtype=torch.bool, device=self.device)
        out = torch.zeros((masks.shape[0], entry.rows), dtype=torch.bool, device=self.device)
        for b in entry.blocks:
            out |= self._block_backward(b, masks[:, b.lo: b.hi])
        return out

    @staticmethod
    def _block_forward(b: _ShardBlock, masks: torch.Tensor) -> torch.Tensor:
        """``masks``: the (B, n_src) probe stack every shard shares."""
        if b.kind == "dense":
            return _bool_product(masks, b.mat)
        return CSR(b.mat.shape[0], b.mat.shape[1], b.mat.crow_indices(),
                   b.mat.col_indices()).neighbor_mask_many(masks)

    @staticmethod
    def _block_backward(b: _ShardBlock, local: torch.Tensor) -> torch.Tensor:
        """``local``: this shard's (B, width) output-slice masks."""
        if b.kind == "dense":
            return _bool_product(local, b.mat.T)
        return (b.mat @ local.to(torch.float32).T).T > 0

    def relation_csr(self, src: str, dst: str) -> torch.Tensor:
        """The full composed relation reassembled from the shard blocks
        (torch sparse CSR, int32 indices, float32 ones) — parity checks and
        the federation hook."""
        base = self.sharded.base
        n_src, n_dst = base.datasets[src].n_rows, base.datasets[dst].n_rows
        entry = self._entry(src, dst)
        rows, cols = [], []
        for b in entry.blocks if entry is not None else []:
            r, c = b.pairs()
            rows.append(r)
            cols.append(c + b.lo)
        empty = torch.zeros(0, dtype=torch.int64, device=self.device)
        return csr_from_pairs(torch.cat(rows) if rows else empty,
                              torch.cat(cols) if cols else empty, n_src, n_dst)

    def stats(self) -> Dict[str, object]:
        per_kind = {"csr": 0, "dense": 0}
        for entry in self._cache.values():
            for b in entry.blocks:
                per_kind[b.kind] += 1
        return {
            "index": self.sharded.name,
            "n_shards": self.sharded.n_shards,
            "entries": len(self._cache),
            "blocks_csr": per_kind["csr"],
            "blocks_dense": per_kind["dense"],
            "bytes": self._bytes,
            "budget_bytes": self.memory_budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


# ---------------------------------------------------------------------------
# The sharded index view
# ---------------------------------------------------------------------------
class ShardedProvenanceIndex:
    """Row-range-sharded view over a :class:`ProvenanceIndex`, on the base
    index's device.

    ``engine="auto"`` runs the collective engine when a process group is
    up with at least ``n_shards`` ranks (this rank among the first
    ``n_shards``), else the sequential per-shard engine (identical
    answers); ``"collective"`` requires the former, ``"numpy"`` forces the
    latter.  ``mesh`` gives the 1-D mesh of ``n_shards`` ranks to use
    instead of :func:`~repro_torch.launch.mesh.make_shard_mesh`'s.  The
    view tracks base appends: ops recorded on the base after construction
    are wrapped on next access."""

    def __init__(self, base: ProvenanceIndex, n_shards: int, *,
                 engine: str = "auto", mesh=None) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.base = base
        self.n_shards = int(n_shards)
        self.engine_name, self._engine = self._make_engine(engine, mesh)
        self._wrapped: List[_ShardedOp] = []
        self._composed: Optional[ShardedComposedIndex] = None
        self._session = None

    def _make_engine(self, engine: str, mesh):
        if engine == "numpy":
            return "sequential", None
        if engine not in ("auto", "collective"):
            raise ValueError(f"unknown engine {engine!r}")
        if mesh is None:
            from repro_torch.launch.mesh import make_shard_mesh

            mesh = make_shard_mesh(self.n_shards, device_type=self.base.device.type)
        elif mesh.ndim != 1 or mesh.size() != self.n_shards:
            raise ValueError(f"the collective engine needs a 1-D mesh of {self.n_shards} "
                             f"ranks, got {mesh}")
        if mesh is None or mesh.get_coordinate() is None:
            if engine == "collective":
                raise RuntimeError(
                    f"the collective engine needs a process group of >= {self.n_shards} "
                    "ranks with this rank among the first n_shards "
                    "(launch.mesh.init_world)")
            return "sequential", None
        return "collective", _CollectiveEngine(mesh)

    # -- view plumbing -------------------------------------------------------
    @property
    def name(self) -> str:
        return f"{self.base.name}@shard{self.n_shards}"

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def datasets(self):
        return self.base.datasets

    @property
    def producer(self):
        return self.base.producer

    @property
    def consumers(self):
        return self.base.consumers

    @property
    def version(self) -> int:
        return self.base.version

    @property
    def ops(self) -> List[_ShardedOp]:
        for op in self.base.ops[len(self._wrapped):]:
            self._wrapped.append(_ShardedOp(
                op_id=op.op_id,
                info=op.info,
                tensor=ShardedTensor(op.tensor, self.n_shards, self._engine),
                input_ids=list(op.input_ids),
                output_id=op.output_id,
            ))
        return self._wrapped

    def _wrap(self, base_ops) -> List[_ShardedOp]:
        ops = self.ops
        return [ops[op.op_id] for op in base_ops]

    def downstream_ops(self, dataset_id: str) -> List[_ShardedOp]:
        return self._wrap(self.base.downstream_ops(dataset_id))

    def upstream_ops(self, dataset_id: str) -> List[_ShardedOp]:
        return self._wrap(self.base.upstream_ops(dataset_id))

    def path_exists(self, src: str, dst: str) -> bool:
        return self.base.path_exists(src, dst)

    def sources(self) -> List[str]:
        return self.base.sources()

    def sinks(self) -> List[str]:
        return self.base.sinks()

    def ranges(self, dataset_id: str) -> List[Tuple[int, int]]:
        """This dataset's shard layout — the partitioning contract every
        tensor slice, hop-cache block, and catalog link follows."""
        return shard_ranges(self.base.datasets[dataset_id].n_rows, self.n_shards)

    def composed(self, **kwargs) -> ShardedComposedIndex:
        if self._composed is None:
            self._composed = ShardedComposedIndex(self, **kwargs)
        elif kwargs:
            raise ValueError("composed() already configured; use composed()")
        return self._composed

    def session(self, **kwargs):
        from repro_torch.provenance.session import QuerySession

        if self._session is None:
            self._session = QuerySession(self, **kwargs)
        elif kwargs:
            raise ValueError("session() already configured; use session()")
        return self._session

    def stats(self) -> Dict[str, object]:
        out = self.base.stats()
        out["n_shards"] = self.n_shards
        out["engine"] = self.engine_name
        return out

    def __repr__(self) -> str:
        return (f"ShardedProvenanceIndex({self.base.name!r}, "
                f"n_shards={self.n_shards}, engine={self.engine_name})")

    # -- federation seam -----------------------------------------------------
    def as_catalog(self, src: str, dst: str, *,
                   root: str = "root", gather: str = "gather"):
        """Register the shards of the composed ``src → dst`` relation as
        :class:`~repro_torch.provenance.catalog.ProvCatalog` members
        stitched by range-alignment links, on the view's device.

        Member graph (acyclic, so federation routing accepts it)::

            root/src --identity--> shard{s}/src --op--> shard{s}/dst@local
                 shard{s}/dst@local --alignment--> gather/dst

        Each shard member is a real single-op :class:`ProvenanceIndex`
        whose tensor is that shard's composed relation block; the range
        alignment maps global dst row ``j`` to shard-local ``j - lo`` inside
        ``[lo, hi)`` and ``-1`` outside.
        """
        from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
        from repro_torch.dataprep.table import Table
        from repro_torch.provenance.catalog import ProvCatalog

        if src == dst:
            raise ValueError("as_catalog needs distinct src and dst datasets")
        base = self.base
        dev = self.device
        n_src = base.datasets[src].n_rows
        n_dst = base.datasets[dst].n_rows

        def _placeholder(n: int) -> Table:
            return Table(columns=["_row"], data=torch.zeros((n, 1), device=dev),
                         null=None, index=None)

        def _table(ds: str, n: int) -> Table:
            t = base.datasets[ds].table
            return t if t is not None else _placeholder(n)

        src_table = _table(src, n_src)
        catalog = ProvCatalog(f"{base.name}-sharded", device=dev)
        root_idx = ProvenanceIndex(root, device=dev)
        root_idx.add_source(src, src_table)
        catalog.register(root, root_idx)
        gather_idx = ProvenanceIndex(gather, device=dev)
        gather_idx.add_source(dst, _table(dst, n_dst))
        catalog.register(gather, gather_idx)

        entry = self.composed()._entry(src, dst)
        if entry is None:
            raise KeyError(f"no dataflow path {src} -> {dst}")
        local_ds = f"{dst}@local"
        for s, block in enumerate(entry.blocks):
            lo, hi = block.lo, block.hi
            member = ProvenanceIndex(f"shard{s}", device=dev)
            member.add_source(src, src_table)
            src_rows, dst_local = block.pairs()
            links = torch.stack([dst_local.to(torch.int32), src_rows.to(torch.int32)], dim=1)
            info = CaptureInfo(
                op_name=f"shard{s}:{src}->{dst}",
                category=OpCategory.HAUGMENT,
                contextual=False,
                n_out=hi - lo,
                n_in=[n_src],
                links=links,
                attr_maps=[AttrMap(kind="identity")],
            )
            member.record([src], local_ds, _placeholder(hi - lo), info)
            catalog.register(f"shard{s}", member)
            catalog.link(f"{root}/{src}", f"shard{s}/{src}")
            alignment = torch.full((n_dst,), -1, dtype=torch.int64, device=dev)
            alignment[lo:hi] = torch.arange(hi - lo, dtype=torch.int64, device=dev)
            catalog.link(f"shard{s}/{local_ds}", f"{gather}/{dst}", alignment=alignment)
        return catalog
