"""Composed hop-cache: memoized multi-hop lineage relations (paper §III-D/§IV).

The twin of ``repro``'s hop-cache, resident on the index's device.
Answering Q1/Q2/Q10/Q11 between DISTANT datasets by walking the op DAG
costs one probe per hop per query; the composition machinery of
:mod:`repro_torch.core.compose` instead contracts the whole path into ONE
composed relation, and this module memoizes those relations so repeated or
batched queries between the same dataset pair become a single batched
probe.

* **Per-entry backends.**  Every cached relation carries its own
  representation tag (:class:`_Entry`): ``csr`` (torch sparse CSR, int32
  indices — composition cost scales with nnz), ``bitplane`` (packed int32
  planes through :func:`~repro_torch.core.compose.compose_pair`, i.e. the
  ``bitmatmul`` kernel for CUDA operands), or ``structured`` (an IMPLICIT
  gather: one int32 array mapping each destination row to its <= 1 source
  row, ``None`` for the pure identity).  ``backend="auto"`` picks per pair
  by the cost model's density threshold and CONVERTS an accumulation that
  densifies past it; ``"csr"`` / ``"bitplane"`` force one representation.
  ``backend=None`` means ``"auto"`` on every device.
* **Closed-form composition algebra** (``auto``): identity steps are
  eliminated, gather∘gather is one take, a dense prefix extends through a
  gather step by a column gather, and append's sibling-branch union stays
  a gather.  Only a multi-parent step or an overlapping union densifies.
* **Multi-path exact** — ``relation(src, dst)`` accumulates over the op
  DAG in topological order, UNIONING the contributions of every input slot
  reachable from ``src``.
* **Lazy + incremental** — every intermediate ``(src, mid)`` accumulation
  is cached; ops recorded later EXTEND warm relations by one closed-form
  step (``_sync``), and a cold multi-hop miss behind a dense prefix is
  gated by :func:`~repro_torch.core.costmodel.extend_vs_recompose`.
* **Eviction-bounded** — an LRU keyed on ``(src, dst)`` with a byte budget
  (``memory_budget_bytes``).  Bytes are counted as ``repro`` counts them.
* **Fast backward probes** — bitplane entries lazily materialize a
  TRANSPOSED plane (accounted against the budget); both probe directions
  are the same select-OR, :func:`~repro_torch.kernels.ops.bitplane_probe`.

* **Spill-backed eviction** — with a ``spill=`` policy
  (:mod:`repro_torch.core.spill`), LRU eviction past the byte budget's
  high watermark serialises entries to the on-disk log (structured gathers
  as one int32 array, CSR as its values/col/crow triple, bitplanes as the
  packed words, written as uint32) instead of dropping them, freeing their
  device memory; a probe of a spilled pair FAULTS it back (one read of the
  log, one host-to-device copy per array, counted in ``rehydrations``)
  rather than recomposing the chain.  Without ``spill=`` eviction drops at
  the budget.

When NO path exists, the probe methods answer empty (matching the walking
engine); ``relation`` itself raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.compose import (
    binary_csr,
    compose_gather,
    compose_pair,
    compose_pair_csr,
    csr_from_pairs,
    csr_pairs,
    extend_tail_bitplane,
    extend_tail_csr,
    op_bitplane,
    op_csr,
)
from repro_torch.core.costmodel import (
    CostModel,
    RelStats,
    extend_vs_recompose,
    pick_backend,
)
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import (
    CSR,
    SlotIdentity,
    bitplane_popcount,
    pack_bitplane,
    unpack_bitplane,
)
from repro_torch.core.spans import HOST_SYNCS, count, count_host_copy
from repro_torch.core.spill import device_tensor, host_array, resolve_spill
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import wrap_int32

__all__ = ["ComposedIndex", "transpose_bitplane"]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def transpose_bitplane(plane: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(rows, ceil(n_cols/32)) packed -> (n_cols, ceil(rows/32)) packed,
    in blocks of output rows so the transient unpack stays bounded."""
    rows = plane.shape[0]
    out = torch.empty((n_cols, (rows + 31) // 32), dtype=torch.int32, device=plane.device)
    words = max(1, (64 << 20) // max(32 * rows, 1))   # ~64 M bits per block
    for w0 in range(0, plane.shape[1], words):
        lo, hi = 32 * w0, min(32 * (w0 + words), n_cols)
        if hi <= lo:
            break
        dense = unpack_bitplane(plane[:, w0: w0 + words].contiguous(), hi - lo)
        out[lo:hi] = pack_bitplane(dense.T.contiguous())
    return out


@dataclasses.dataclass
class _Entry:
    """One cached composed relation, tagged with its representation.

    ``structured`` entries hold the relation implicitly: ``rel`` is an int32
    ``(cols,)`` gather mapping each destination row to its (at most one)
    source row, ``-1`` = no link — or ``None`` for the pure identity
    (``rows == cols``), which costs nothing at all."""

    backend: str              # "csr" | "bitplane" | "structured"
    rel: object               # torch sparse CSR (float32 ones), packed int32
                              # plane, or int32 gather (None = identity)
    rows: int                 # |src|
    cols: int                 # |dst|
    nnz: int
    relT: Optional[torch.Tensor] = None  # lazy (cols, ceil(rows/32)) transposed plane

    @property
    def density(self) -> float:
        cells = self.rows * self.cols
        return self.nnz / cells if cells else 0.0

    def nbytes(self) -> int:
        if self.backend == "structured":
            total = 0 if self.rel is None else _nbytes(self.rel)
        elif self.backend == "csr":
            r = self.rel
            total = _nbytes(r.values()) + _nbytes(r.col_indices()) + _nbytes(r.crow_indices())
        else:
            total = _nbytes(self.rel)
        if self.relT is not None:
            total += _nbytes(self.relT)
        return total

    def gather(self, device) -> torch.Tensor:
        """The structured entry's (cols,) destination -> source map, with
        the identity materialized on demand."""
        if self.rel is not None:
            return self.rel
        return torch.arange(self.cols, dtype=torch.int32, device=device)


def _count(mask: torch.Tensor) -> int:
    count(HOST_SYNCS)
    return int(torch.count_nonzero(mask))


class ComposedIndex:
    """Memoized composed-relation store + batched probe engine over one
    :class:`ProvenanceIndex`, on the index's device."""

    def __init__(
        self,
        index: ProvenanceIndex,
        memory_budget_bytes: int = 64 << 20,
        backend: Optional[str] = None,
        spill=None,
        extend_eager: bool = True,
    ) -> None:
        if backend is None:
            backend = "auto"
        if backend not in ("auto", "csr", "bitplane"):
            raise ValueError(f"unknown backend {backend!r}")
        self.index = index
        self.device = index.device
        self.backend = backend
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.extend_eager = bool(extend_eager)
        self.costmodel = CostModel(index)
        self._cache: "OrderedDict[Tuple[str, str], _Entry]" = OrderedDict()
        self._bytes = 0
        self._ops_seen = len(index.ops)
        # probed-through sources: reach sets maintained incrementally
        self._reach: Dict[str, set] = {}
        self._spill = resolve_spill(spill)
        self._spill_store = self._spill.ensure_store() if self._spill else None
        # keys whose entry is on disk and NOT resident; plus what the disk
        # copy holds (backend, nnz) so an unchanged re-eviction skips the
        # write (composed relations are immutable under the append-only DAG)
        self._spilled: "OrderedDict[Tuple[str, str], bool]" = OrderedDict()
        self._store_meta: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.conversions = 0
        self.extends = 0
        self.recomposes = 0
        self.spills = 0
        self.rehydrations = 0

    # -- cache plumbing -----------------------------------------------------
    def _sync(self) -> None:
        """Reconcile with the index after writes — incrementally.

        The op DAG is append-only (one producer per dataset), so composed
        relations between existing datasets stay exact and the cache is
        kept.  Ops recorded since the last sync are drained once: every
        tracked source's reach set absorbs them, and (``extend_eager``, auto
        backend) a new op whose on-path slots are all structured and whose
        on-path prefixes are all cached EXTENDS the warm relations by one
        closed-form step now; a spilled op tensor on that path is faulted
        back for it.  Without ``extend_eager`` the next probe extends
        lazily."""
        n = len(self.index.ops)
        if n > self._ops_seen:
            for op in self.index.ops[self._ops_seen:n]:
                self._absorb_op(op)
            self._ops_seen = n

    def _absorb_op(self, op) -> None:
        for src, reach in self._reach.items():
            slots = [k for k, d in enumerate(op.input_ids) if d in reach]
            if not slots:
                continue
            reach.add(op.output_id)
            if not (self.extend_eager and self.backend == "auto"):
                continue
            if not op.tensor.structured:
                continue
            prefixes = {}
            for k in slots:
                d = op.input_ids[k]
                if d == src:
                    prefixes[k] = None
                else:
                    e = self._cache.get((src, d))
                    if e is None:
                        break  # cold/partial prefix: a partial union is wrong
                    prefixes[k] = e
            if len(prefixes) != len(slots):
                continue
            # the extension reads the gather slot: fault a spilled tensor
            # back now rather than leave the relation to a full recompose
            op.tensor.resident()
            acc: Optional[_Entry] = None
            for k in slots:
                contrib = self._extend(prefixes[k], op, k)
                acc = contrib if acc is None else self._union(acc, contrib)
            self._insert((src, op.output_id), self._settle(acc))
            self.extends += 1

    def _reach_set(self, src: str) -> set:
        """Datasets reachable from ``src`` — one full op scan on the first
        probe through ``src``, then maintained per appended op by
        ``_sync``."""
        reach = self._reach.get(src)
        if reach is None:
            reach = {src}
            for op in self.index.ops:
                if any(d in reach for d in op.input_ids):
                    reach.add(op.output_id)
            self._reach[src] = reach
        return reach

    def _evict_over_budget(self) -> None:
        if self._spill is None:
            while self._bytes > self.memory_budget_bytes and len(self._cache) > 1:
                _, evicted = self._cache.popitem(last=False)
                self._bytes -= evicted.nbytes()
                self.evictions += 1
            return
        # spill tier: watermark hysteresis — start evicting past high,
        # spill LRU entries to disk down to low, so an append stream pays
        # one burst of writes per crossing instead of one per insert
        high = self.memory_budget_bytes * self._spill.high_watermark
        low = self.memory_budget_bytes * self._spill.low_watermark
        if self._bytes <= high:
            return
        while self._bytes > low and len(self._cache) > 1:
            key, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.nbytes()
            self.evictions += 1
            self._spill_entry(key, evicted)

    def _store_key(self, key: Tuple[str, str]) -> tuple:
        return ("rel", self.index.name) + key

    def _spill_entry(self, key: Tuple[str, str], entry: _Entry) -> None:
        entry.relT = None  # lazily rebuilt after a fault; never serialised
        if self._store_meta.get(key) != (entry.backend, entry.nnz):
            meta = {"backend": entry.backend, "rows": entry.rows,
                    "cols": entry.cols, "nnz": entry.nnz,
                    "identity": entry.backend == "structured" and entry.rel is None}
            if entry.backend == "structured":
                arrays = {} if entry.rel is None else {"gather": host_array(entry.rel)}
            elif entry.backend == "csr":
                r = entry.rel
                arrays = {"data": host_array(r.values()),
                          "indices": host_array(r.col_indices()),
                          "indptr": host_array(r.crow_indices())}
            else:
                arrays = {"plane": host_array(entry.rel, packed=True)}
            self._spill_store.put(self._store_key(key), arrays, meta)
            self._store_meta[key] = (entry.backend, entry.nnz)
        self._spilled[key] = True
        self.spills += 1

    def _fault(self, key: Tuple[str, str]) -> Optional[_Entry]:
        """Rehydrate one spilled composed relation onto the device, byte for
        byte what was evicted; the entry re-enters the LRU as MRU."""
        try:
            meta, arrays = self._spill_store.get(self._store_key(key))
        except KeyError:
            self._spilled.pop(key, None)
            self._store_meta.pop(key, None)
            return None  # dropped by a disk budget: rebuild from scratch
        dev = self.device
        backend = meta["backend"]
        rows, cols, nnz = int(meta["rows"]), int(meta["cols"]), int(meta["nnz"])
        if backend == "structured":
            rel = None if meta["identity"] else device_tensor(arrays["gather"], dev)
        elif backend == "csr":
            rel = torch.sparse_csr_tensor(
                device_tensor(arrays["indptr"], dev), device_tensor(arrays["indices"], dev),
                device_tensor(arrays["data"], dev), size=(rows, cols), check_invariants=False)
        else:
            rel = device_tensor(arrays["plane"], dev)
        entry = _Entry(backend, rel, rows, cols, nnz)
        self._spilled.pop(key, None)
        self.rehydrations += 1
        self._insert(key, entry)
        if key not in self._cache:
            self._spilled[key] = True  # declined (over budget); disk copy stays
        return entry

    def _insert(self, key: Tuple[str, str], entry: _Entry) -> None:
        nbytes = entry.nbytes()
        if nbytes > self.memory_budget_bytes:
            # larger than the whole budget: with a spill tier, park it on
            # disk (a fault beats recomposing the chain); without one,
            # serve uncached
            if self._spill_store is not None:
                self._spill_entry(key, entry)
            return
        old = self._cache.pop(key, None)
        if old is not None:
            # overwrite releases the old entry's bytes FIRST
            self._bytes -= old.nbytes()
        self._cache[key] = entry
        self._bytes += nbytes
        self._spilled.pop(key, None)  # resident again; disk copy kept as-is
        self._evict_over_budget()

    def _lookup(self, key: Tuple[str, str]) -> Optional[_Entry]:
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            return entry
        if key in self._spilled:
            return self._fault(key)
        return None

    def _peek(self, key: Tuple[str, str]) -> bool:
        """Composed and answerable without recomposition (resident OR
        spilled) — no LRU touch, no fault, no composition."""
        return key in self._cache or key in self._spilled

    # -- backend primitives ---------------------------------------------------
    def _resolve_backend(self, density: float) -> str:
        """Representation for a relation of the given density (auto mode:
        the cost model's threshold; forced modes: the forced backend)."""
        if self.backend != "auto":
            return self.backend
        return pick_backend(density)

    def _identity_entry(self, n: int) -> _Entry:
        if self.backend == "auto":
            # the src == dst relation IS the identity: store nothing
            return _Entry("structured", None, n, n, n)
        backend = self._resolve_backend(1.0 / n if n else 0.0)
        i = torch.arange(n, dtype=torch.int64, device=self.device)
        if backend == "csr":
            return _Entry("csr", binary_csr(torch.arange(n + 1, device=self.device), i, n, n),
                          n, n, n)
        words = torch.zeros((n, max((n + 31) // 32, 1)), dtype=torch.int32, device=self.device)
        words[i, i // 32] = wrap_int32(torch.ones_like(i) << (i % 32))
        return _Entry("bitplane", words, n, n, n)

    def _step_rel(self, op, slot: int, backend: str):
        return op_csr(op.tensor, slot) if backend == "csr" \
            else op_bitplane(op.tensor, slot)

    def _structured_pairs(self, entry: _Entry):
        """Valid (source_row, dest_row) int64 link pairs of a structured
        entry."""
        if entry.rel is None:
            i = torch.arange(entry.rows, dtype=torch.int64, device=self.device)
            return i, i
        count(HOST_SYNCS)
        dst = torch.nonzero(entry.rel >= 0).reshape(-1)
        return entry.rel[dst].to(torch.int64), dst

    def _to_bitplane(self, entry: _Entry) -> _Entry:
        if entry.backend == "bitplane":
            return entry
        self.conversions += 1
        if entry.backend == "structured":
            src, dst = self._structured_pairs(entry)
        else:
            src, dst = csr_pairs(entry.rel)
        dense = torch.zeros((entry.rows, entry.cols), dtype=torch.bool, device=self.device)
        dense[src, dst] = True
        count_host_copy(self.device)
        return _Entry("bitplane", pack_bitplane(dense), entry.rows, entry.cols, entry.nnz)

    def _to_csr(self, entry: _Entry) -> _Entry:
        if entry.backend == "csr":
            return entry
        self.conversions += 1
        if entry.backend == "structured":
            src, dst = self._structured_pairs(entry)
        else:
            count(HOST_SYNCS)
            src, dst = torch.nonzero(unpack_bitplane(entry.rel, entry.cols), as_tuple=True)
        return _Entry("csr", csr_from_pairs(src, dst, entry.rows, entry.cols),
                      entry.rows, entry.cols, entry.nnz)

    def _densify(self, entry: _Entry) -> _Entry:
        """A structured entry leaving the closed-form algebra: the
        representation the density picks."""
        if entry.backend != "structured":
            return entry
        return self._to_csr(entry) if pick_backend(entry.density) == "csr" \
            else self._to_bitplane(entry)

    def _structured_step_entry(self, op, slot: int) -> _Entry:
        t = op.tensor
        s = t.slot_structure(slot)
        rel = None if isinstance(s, SlotIdentity) else t.slot_gather(slot)
        return _Entry("structured", rel, t.n_in[slot], t.n_out, t.slot_nnz(slot))

    @staticmethod
    def _copy(rel):
        # both entries live in the cache under their own keys: aliased
        # arrays would make the budget double-count bytes
        return None if rel is None else rel.clone()

    def _extend(self, prefix: Optional[_Entry], op, slot: int) -> _Entry:
        """``prefix ∘ op[slot]`` as a fresh entry (prefix None = identity).
        Closed forms first (``auto`` mode); only an unstructured step
        densifies the prefix and falls back to a sparse or packed product."""
        t = op.tensor
        s = t.slot_structure(slot) if self.backend == "auto" else None
        if prefix is None:
            if s is not None:
                return self._structured_step_entry(op, slot)
            backend = self._resolve_backend(t.slot_density(slot))
            return _Entry(backend, self._step_rel(op, slot, backend),
                          t.n_in[slot], t.n_out, t.slot_nnz(slot))
        if isinstance(s, SlotIdentity):
            # identity elimination: prefix ∘ I = prefix (copied, no product)
            return _Entry(prefix.backend, self._copy(prefix.rel), prefix.rows, t.n_out,
                          prefix.nnz)
        if prefix.backend == "structured":
            if prefix.rel is None:
                # identity prefix: the step's own relation is the result
                return self._extend(None, op, slot)
            if s is not None:
                g_new = compose_gather(prefix.rel, t.slot_gather(slot))
                return _Entry("structured", g_new, prefix.rows, t.n_out, _count(g_new >= 0))
            prefix = self._densify(prefix)
        if s is not None:
            # DENSE prefix ∘ structured step: the closed-form tail extension
            g_step = t.slot_gather(slot)
            if prefix.backend == "csr":
                rel = extend_tail_csr(prefix.rel, g_step)
                return _Entry("csr", rel, prefix.rows, t.n_out, rel.values().shape[0])
            rel = extend_tail_bitplane(prefix.rel, g_step, prefix.cols)
            return _Entry("bitplane", rel, prefix.rows, t.n_out, bitplane_popcount(rel))
        step = self._step_rel(op, slot, prefix.backend)
        if prefix.backend == "csr":
            rel = compose_pair_csr(prefix.rel, step)
            nnz = rel.values().shape[0]
        else:
            rel = compose_pair(prefix.rel, step, t.n_in[slot])
            nnz = bitplane_popcount(rel)
        return _Entry(prefix.backend, rel, prefix.rows, t.n_out, nnz)

    def _union(self, a: _Entry, b: _Entry) -> _Entry:
        """(OR)-union two relations — the sum over parallel DAG paths.  Two
        structured gathers whose links never disagree stay structured;
        everything else densifies, and mixed representations meet on the
        packed plane."""
        if a.backend == "structured" and b.backend == "structured":
            ga, gb = a.gather(self.device), b.gather(self.device)
            both = (ga >= 0) & (gb >= 0)
            count(HOST_SYNCS)
            disjoint = not bool(both.any())
            if not disjoint:
                count(HOST_SYNCS, 3)    # two boolean indexes, the comparison
            if disjoint or torch.equal(ga[both], gb[both]):
                g = torch.where(ga >= 0, ga, gb)
                return _Entry("structured", g, a.rows, a.cols, _count(g >= 0))
        a, b = self._densify(a), self._densify(b)
        if a.backend != b.backend:
            a, b = self._to_bitplane(a), self._to_bitplane(b)
        if a.backend == "csr":
            rel = a.rel + b.rel
            rel = binary_csr(rel.crow_indices(), rel.col_indices(), a.rows, a.cols)
            return _Entry("csr", rel, a.rows, a.cols, rel.values().shape[0])
        rel = torch.bitwise_or(a.rel, b.rel)
        return _Entry("bitplane", rel, a.rows, a.cols, bitplane_popcount(rel))

    def _compose_entries(self, a: _Entry, b: _Entry) -> _Entry:
        """Generic ``a ∘ b`` over already-composed entries (``a`` maps
        X -> Y, ``b`` maps Y -> Z) — the recompose path's fold primitive,
        with the same closed forms as :meth:`_extend`."""
        if a.backend == "structured" and a.rel is None:
            return _Entry(b.backend, self._copy(b.rel), a.rows, b.cols, b.nnz)
        if b.backend == "structured" and b.rel is None:
            return _Entry(a.backend, self._copy(a.rel), a.rows, b.cols, a.nnz)
        if b.backend == "structured":
            if a.backend == "structured":
                g = compose_gather(a.rel, b.rel)
                return _Entry("structured", g, a.rows, b.cols, _count(g >= 0))
            if a.backend == "csr":
                rel = extend_tail_csr(a.rel, b.rel)
                return _Entry("csr", rel, a.rows, b.cols, rel.values().shape[0])
            rel = extend_tail_bitplane(a.rel, b.rel, a.cols)
            return _Entry("bitplane", rel, a.rows, b.cols, bitplane_popcount(rel))
        a = self._densify(a)
        if a.backend != b.backend:
            b = self._to_csr(b) if a.backend == "csr" else self._to_bitplane(b)
        if a.backend == "csr":
            rel = compose_pair_csr(a.rel, b.rel)
            return _Entry("csr", rel, a.rows, b.cols, rel.values().shape[0])
        rel = compose_pair(a.rel, b.rel, b.rows)
        return _Entry("bitplane", rel, a.rows, b.cols, bitplane_popcount(rel))

    def _settle(self, entry: _Entry) -> _Entry:
        """auto mode: convert an accumulation whose observed density crossed
        the cost model's threshold.  Structured entries never settle."""
        if self.backend != "auto" or entry.backend == "structured":
            return entry
        want = pick_backend(entry.density)
        if want == entry.backend:
            return entry
        return self._to_bitplane(entry) if want == "bitplane" else self._to_csr(entry)

    # -- the composed relation ----------------------------------------------
    def _pending_ops(self, src: str, dst: str, reach: set) -> List[object]:
        """Ops that must run to compose ``(src, dst)``: backward DFS from
        ``dst``, stopping at ``src`` and at datasets whose ``(src, .)``
        relation is already composed (resident or spilled) — in
        topological (op-id) order."""
        pending: Dict[int, object] = {}
        visited = set()
        stack = [dst]
        while stack:
            d = stack.pop()
            if d == src or d in visited:
                continue
            visited.add(d)
            if self._peek((src, d)):
                continue
            op = self.index.ops[self.index.producer[d]]
            pending[op.op_id] = op
            for in_id in op.input_ids:
                if in_id in reach:
                    stack.append(in_id)
        return [pending[i] for i in sorted(pending)]

    @staticmethod
    def _linear_tail(pending: List[object], reach: set):
        """``(base_dataset, [(op, slot), ...])`` when the pending ops form
        one single-parent chain, else None."""
        steps = []
        base = None
        prev_out = None
        for op in pending:
            slots = [k for k, d in enumerate(op.input_ids) if d in reach]
            if len(slots) != 1:
                return None
            in_id = op.input_ids[slots[0]]
            if prev_out is None:
                base = in_id
            elif in_id != prev_out:
                return None
            prev_out = op.output_id
            steps.append((op, slots[0]))
        return base, steps

    def _step_entry(self, op, slot: int) -> _Entry:
        """One op slot's own relation as an entry (the tail fold's leaves)."""
        t = op.tensor
        if self.backend == "auto" and t.slot_structure(slot) is not None:
            return self._structured_step_entry(op, slot)
        backend = self._resolve_backend(t.slot_density(slot))
        return _Entry(backend, self._step_rel(op, slot, backend),
                      t.n_in[slot], t.n_out, t.slot_nnz(slot))

    def _relation_entry(self, src: str, dst: str) -> _Entry:
        self._sync()
        cached = self._lookup((src, dst))
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        if src == dst:
            entry = self._identity_entry(self.index.datasets[src].n_rows)
            self._insert((src, dst), entry)
            return entry
        reach = self._reach_set(src)
        if dst not in reach:
            raise KeyError(f"no dataflow path {src} -> {dst}")
        pending = self._pending_ops(src, dst, reach)
        pending_out = {op.output_id for op in pending}
        # resolve every boundary prefix FIRST, before any insert below can
        # evict one; local holds live references
        local: Dict[str, Optional[_Entry]] = {src: None}  # None = identity
        for op in pending:
            for in_id in op.input_ids:
                if (in_id in reach and in_id != src
                        and in_id not in pending_out and in_id not in local):
                    hit = self._lookup((src, in_id))
                    if hit is not None:
                        self.hits += 1
                    else:
                        # evicted between the DFS and here: rebuild it
                        hit = self._relation_entry(src, in_id)
                    local[in_id] = hit
        # cost-model gate (dense warm prefix, multi-step tail): fold the
        # tail first in the chain DP's order and apply it to the prefix once
        if len(pending) >= 2:
            lin = self._linear_tail(pending, reach)
            if lin is not None and lin[0] in local:
                base, steps = lin
                prefix = local[base]
                if prefix is not None and prefix.backend != "structured":
                    pstats = RelStats(prefix.rows, prefix.cols, prefix.nnz, structured=False)
                    tstats = [RelStats.from_slot(op.tensor, k) for op, k in steps]
                    verdict = extend_vs_recompose(pstats, tstats)
                    if verdict["strategy"] == "recompose":
                        entries = [self._step_entry(op, k) for op, k in steps]
                        for (i, _k) in verdict["tail_order"]:
                            j = i + 1
                            while entries[j] is None:
                                j += 1
                            entries[i] = self._compose_entries(entries[i], entries[j])
                            entries[j] = None
                        folded = next(e for e in entries if e is not None)
                        acc = self._settle(self._compose_entries(prefix, folded))
                        self.recomposes += 1
                        self._insert((src, dst), acc)
                        return acc
        # stepwise accumulation in topo order: UNION over on-path input
        # slots of (prefix ∘ slot step); every intermediate is cached
        rels = local
        for op in pending:
            acc: Optional[_Entry] = None
            for k, in_id in enumerate(op.input_ids):
                if in_id not in rels:
                    continue  # input unreachable from src: contributes nothing
                contrib = self._extend(rels[in_id], op, k)
                acc = contrib if acc is None else self._union(acc, contrib)
            if acc is None:
                continue
            acc = self._settle(acc)
            rels[op.output_id] = acc
            self._insert((src, op.output_id), acc)
        if len(pending) == 1:
            self.extends += 1
        elif len(pending) > 1:
            self.recomposes += 1
        if dst not in rels or rels[dst] is None:
            raise KeyError(f"no dataflow path {src} -> {dst}")
        return rels[dst]

    def relation(self, src: str, dst: str):
        """The composed ``src`` -> ``dst`` relation, from cache or composed
        incrementally: torch sparse CSR or packed bitplane per the entry's
        backend (see :meth:`relation_backend`); a ``structured`` entry
        answers a COPY of its int32 destination -> source gather (identity
        chains materialize the arange) — a copy because the cached gather
        may BE an op tensor's own capture payload."""
        entry = self._relation_entry(src, dst)
        if entry.backend == "structured":
            return entry.gather(self.device).clone()
        return entry.rel

    def relation_backend(self, src: str, dst: str) -> str:
        """Which representation the (composed-on-demand) relation uses."""
        return self._relation_entry(src, dst).backend

    def relation_csr(self, src: str, dst: str) -> torch.Tensor:
        """The composed relation as a torch sparse CSR COPY (int32 indices,
        float32 ones) whatever the entry's backend — the federation's
        cross-index composition hook (a
        :class:`~repro_torch.provenance.catalog.BoundaryHandle` grants
        exactly this read for boundary-ancestor pairs).  Bitplane and
        structured entries convert TRANSIENTLY: the cache entry, its backend
        tag and the conversion counter are untouched."""
        entry = self._relation_entry(src, dst)
        if entry.backend == "csr":
            # a COPY: handing out the live cached arrays would let a
            # "read-only" BoundaryHandle corrupt the index's private cache
            r = entry.rel
            return torch.sparse_csr_tensor(
                r.crow_indices().clone(), r.col_indices().clone(), r.values().clone(),
                size=(entry.rows, entry.cols), check_invariants=False)
        if entry.backend == "structured":
            src_rows, dst_rows = self._structured_pairs(entry)
            return csr_from_pairs(src_rows, dst_rows, entry.rows, entry.cols)
        # unpack in row blocks: a large packed plane must not transiently
        # materialize the full (rows, cols) bool array just to re-sparsify it
        step = max(1, (4 << 20) // max(entry.cols, 1))
        rows, cols = [], []
        for lo in range(0, entry.rows, step):
            r, c = torch.nonzero(unpack_bitplane(entry.rel[lo: lo + step], entry.cols),
                                 as_tuple=True)
            rows.append(r + lo)
            cols.append(c)
        if not rows:
            rows = cols = [torch.zeros(0, dtype=torch.int64, device=self.device)]
        return csr_from_pairs(torch.cat(rows), torch.cat(cols), entry.rows, entry.cols)

    # -- batched probes -------------------------------------------------------
    def _try_relation(self, src: str, dst: str) -> Optional[_Entry]:
        """``_relation_entry`` for probes: no dataflow path -> None (probes
        answer empty, matching the walking engine)."""
        try:
            return self._relation_entry(src, dst)
        except KeyError:
            return None

    def _entry_relT(self, key: Tuple[str, str], entry: _Entry) -> torch.Tensor:
        """The transposed plane of a bitplane entry, materialized lazily and
        accounted against the byte budget.  A CACHED entry only retains it
        when rel + relT still fit the budget; otherwise it is served
        transiently."""
        if entry.relT is not None:
            return entry.relT
        relT = transpose_bitplane(entry.rel, entry.cols)
        if self._cache.get(key) is not entry:
            entry.relT = relT       # transient entry: lives only this call
        elif entry.nbytes() + _nbytes(relT) <= self.memory_budget_bytes:
            entry.relT = relT
            self._bytes += _nbytes(relT)
            self._evict_over_budget()
        return relT

    def _forward_probe(self, masks: torch.Tensor, src: str, dst: str) -> torch.Tensor:
        """(B, |src|) bool -> (B, |dst|) bool through the composed relation."""
        entry = self._try_relation(src, dst)
        if entry is None:
            return torch.zeros((masks.shape[0], self.index.datasets[dst].n_rows),
                               dtype=torch.bool, device=self.device)
        if entry.backend == "structured":
            # one take along the gather: out[b, d] = masks[b, g[d]]
            if entry.rel is None:
                return masks[:, : entry.cols].clone()
            g = entry.rel
            valid = g >= 0
            safe = torch.where(valid, g, torch.zeros_like(g)).long()
            return masks[:, : entry.rows][:, safe] & valid[None, :]
        if entry.backend == "csr":
            crow, col = entry.rel.crow_indices(), entry.rel.col_indices()
            return CSR(entry.rows, entry.cols, crow, col).neighbor_mask_many(masks)
        words = K.bitplane_probe(pack_bitplane(masks[:, : entry.rows]), entry.rel)
        return unpack_bitplane(words, entry.cols)

    def _backward_probe(self, masks: torch.Tensor, src: str, dst: str) -> torch.Tensor:
        """(B, |dst|) bool -> (B, |src|) bool: rows of the composed relation
        intersecting each probe set.  Bitplane entries answer through the
        lazily cached TRANSPOSED plane with the same select-OR as forward
        probes."""
        entry = self._try_relation(src, dst)
        if entry is None:
            return torch.zeros((masks.shape[0], self.index.datasets[src].n_rows),
                               dtype=torch.bool, device=self.device)
        if entry.backend == "structured":
            # one scatter through the gather: out[b, g[d]] |= masks[b, d]
            if entry.rel is None:
                return masks[:, : entry.rows].clone()
            g = entry.rel
            out = torch.zeros((masks.shape[0], entry.rows), dtype=torch.bool,
                              device=self.device)
            sel = masks[:, : entry.cols] & (g >= 0)[None, :]
            count(HOST_SYNCS)
            bs, ds = torch.nonzero(sel, as_tuple=True)
            out[bs, g[ds].long()] = True
            count_host_copy(self.device)
            return out
        if entry.backend == "csr":
            return (entry.rel @ masks[:, : entry.cols].to(torch.float32).T).T > 0
        relT = self._entry_relT((src, dst), entry)
        words = K.bitplane_probe(pack_bitplane(masks[:, : entry.cols]), relT)
        return unpack_bitplane(words, entry.rows)

    # -- mask-stack probes (the QuerySession entry points) ---------------------
    def contains(self, src: str, dst: str) -> bool:
        """Whether the ``src`` -> ``dst`` relation is already composed (no
        LRU touch, no composition) — the planner's routing test.  A SPILLED
        entry counts: faulting it back is one read of the log, far cheaper
        than the walk or recompose the router would otherwise pick."""
        self._sync()
        return self._peek((src, dst))

    def residency(self, src: str, dst: str) -> Optional[str]:
        """Where the composed ``(src, dst)`` relation lives right now:
        ``"ram"`` (resident on the index's device), ``"spilled"`` (on
        disk), or None (not composed).  No LRU touch, no fault — the
        EXPLAIN surface reads this."""
        self._sync()
        if (src, dst) in self._cache:
            return "ram"
        if (src, dst) in self._spilled:
            return "spilled"
        return None

    def _stack(self, masks) -> torch.Tensor:
        return torch.as_tensor(masks).to(device=self.device, dtype=torch.bool)

    def probe_forward(self, masks, src: str, dst: str) -> torch.Tensor:
        """(B, |src|) bool mask stack -> (B, |dst|) bool via the composed
        relation.  No path -> all-empty (matching the walking engine)."""
        return self._forward_probe(self._stack(masks), src, dst)

    def probe_backward(self, masks, dst: str, src: str) -> torch.Tensor:
        """(B, |dst|) bool mask stack -> (B, |src|) bool: relation rows
        intersecting each probe set."""
        return self._backward_probe(self._stack(masks), src, dst)

    # -- impact invalidation --------------------------------------------------
    def stale_entries(self, datasets) -> List[Tuple[str, str, str]]:
        """Composed entries (resident or spilled) whose ``src`` -> ``dst``
        DAG region intersects ``datasets``, as ``(src, dst, residency)``
        triples — the relations an erasure or rewrite of those datasets'
        rows leaves stale.  Enumeration only: nothing is dropped, no LRU
        touch, no fault."""
        self._sync()
        affected = [d for d in set(datasets) if d in self.index.datasets]
        if not affected:
            return []
        keys = [(k, "ram") for k in self._cache]
        keys += [(k, "spilled") for k in self._spilled]
        out = []
        for (src, dst), residency in keys:
            if any(self.index.path_exists(src, m) and self.index.path_exists(m, dst)
                   for m in affected):
                out.append((src, dst, residency))
        return out

    def invalidate_datasets(self, datasets) -> List[Tuple[str, str, str]]:
        """Drop every :meth:`stale_entries` entry: resident entries leave the
        LRU (their bytes released), disk copies are DELETED from the spill
        store.  Returns the dropped triples."""
        dropped = self.stale_entries(datasets)
        for src, dst, _residency in dropped:
            key = (src, dst)
            entry = self._cache.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes()
            self._spilled.pop(key, None)
            # a resident entry may ALSO hold a stale disk copy (spilled
            # once, faulted back): _store_meta remembers it — delete both
            if key in self._store_meta:
                del self._store_meta[key]
                self._spill_store.delete(self._store_key(key))
        return dropped

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        per_backend = {"csr": 0, "bitplane": 0, "structured": 0}
        for entry in self._cache.values():
            per_backend[entry.backend] += 1
        out = {
            "index": self.index.name,
            "backend": self.backend,
            "entries": len(self._cache),
            "entries_csr": per_backend["csr"],
            "entries_bitplane": per_backend["bitplane"],
            "entries_structured": per_backend["structured"],
            "bytes": self._bytes,
            "budget_bytes": self.memory_budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "conversions": self.conversions,
            "extends": self.extends,
            "recomposes": self.recomposes,
            "spills": self.spills,
            "rehydrations": self.rehydrations,
            "spilled_entries": len(self._spilled),
        }
        if self._spill_store is not None:
            out["spill"] = self._spill_store.stats()
        return out
