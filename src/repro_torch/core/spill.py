"""Out-of-core spill tier: bounded residency for op tensors and composed
relations.

Before this module every recorded op tensor and every composed hop-cache
entry stayed resident on the index's device for good (or, for the
hop-cache, was dropped at eviction and recomposed from scratch on the next
probe).  This module gives both stores a third place to put cold state: a
compact append-only on-disk log read back through memory maps, so

* **capture residency is bounded** — :class:`TensorSpiller` (wired through
  ``ProvenanceIndex(spill=...)``) keeps a byte-budgeted LRU of resident op
  tensors and serialises cold ones (structured slots as their int
  payloads, explicit COO as the index list); spilling a tensor frees its
  device memory — payload, CSR halves and bitplanes;
* **eviction is not amnesia** — a :class:`~repro_torch.core.hopcache.ComposedIndex`
  configured with ``spill=`` writes LRU-evicted composed relations to the
  store and FAULTS them back on the next probe instead of recomposing the
  chain.

On the card the resident tier is device memory (HBM); the log lives on the
host's disk.  The format is ``repro``'s RSPL1 log, byte for byte: a log of
size-rotated SEGMENT files,

    [MAGIC][u32 header_len][json header][pad to 64][array bytes, 64-aligned]*

so the same puts give the same segment files in both packages.  Packed
int32 words are written as uint32 (a numpy ``.view``, the packages' parity
boundary) and read back as int32.  :meth:`SpillStore.get` hands back
read-only ``np.memmap`` views, as ``repro``'s does; the port's readers copy
each array once out of the page cache (torch cannot wrap a read-only
mapping safely) and, for an index on the card, move it to the device in
one host-to-device copy.  So ``repro``'s zero-copy read path holds here
only up to that one host copy, and only for an index on the CPU.  The
in-memory key index is authoritative; the on-disk headers are for
forensics only — a :class:`SpillStore` is an ephemeral extension of
memory for one process, not a durable database.

Disk reclamation is log-structured: deleting an entry marks its bytes dead,
and a segment whose entries are all dead is unlinked whole.  An optional
``disk_budget_bytes`` drops the OLDEST segments (live entries in them are
gone — counted in ``drops``); the tensor spiller never sets one, because a
dropped op tensor would lose recorded provenance.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import tempfile
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SpillStore",
    "SpillPolicy",
    "TensorSpiller",
    "resolve_spill",
]

_MAGIC = b"RSPL1\x00"
_ALIGN = 64


def _pad(n: int) -> int:
    return (-n) % _ALIGN


def host_array(x, packed: bool = False) -> np.ndarray:
    """A tensor (any device) or array -> the host array the log stores;
    ``packed`` int32 words go out as uint32, as ``repro`` holds them."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if packed else a


def device_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A (read-only, memmap-backed) host array -> a tensor on ``device``:
    one copy out of the page cache, then one host-to-device copy; uint32
    words come back as int32 with the same bits."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass
class _StoredArray:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int          # absolute offset within the segment file
    nbytes: int


@dataclasses.dataclass
class _StoredEntry:
    seg: int
    meta: dict
    arrays: List[_StoredArray]
    nbytes: int          # total payload bytes (the live-byte accounting unit)


class SpillStore:
    """Append-only segmented spill log with memory-mapped read-back.

    ``root=None`` creates a private temp directory removed on :meth:`close`
    (and best-effort at garbage collection).  Keys are arbitrary hashables
    (the hop-cache uses ``("rel", index, src, dst)`` tuples, the tensor
    spiller ``("op", index, op_id)``), kept in an insertion-ordered
    in-memory index — oldest first, which is also segment order, so the
    disk-budget drop walks whole segments.  Single-process, single-thread
    use (matching the rest of the host query engine)."""

    def __init__(self, root: Optional[str] = None, *,
                 segment_bytes: int = 64 << 20,
                 disk_budget_bytes: Optional[int] = None) -> None:
        self._owns_root = root is None
        if root is None:
            root = tempfile.mkdtemp(prefix="repro_torch-spill-")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.segment_bytes = int(segment_bytes)
        self.disk_budget_bytes = disk_budget_bytes
        self._index: "OrderedDict[object, _StoredEntry]" = OrderedDict()
        self._seg_bytes: Dict[int, int] = {}       # seg -> file bytes
        self._seg_live: Dict[int, int] = {}        # seg -> live entry count
        self._maps: Dict[int, Tuple[np.memmap, int]] = {}
        self._active = 0
        self._fh = open(self._seg_path(0), "ab")
        self._seg_bytes[0] = 0
        self._seg_live[0] = 0
        self._closed = False
        self.writes = 0
        self.reads = 0
        self.drops = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self._dead_bytes = 0

    # -- segment plumbing -----------------------------------------------------
    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.root, f"seg{seg:06d}.spill")

    def _rotate(self) -> None:
        self._fh.close()
        self._maps.pop(self._active, None)
        self._active += 1
        self._fh = open(self._seg_path(self._active), "ab")
        self._seg_bytes[self._active] = 0
        self._seg_live[self._active] = 0

    def _drop_segment(self, seg: int) -> None:
        """Unlink one non-active segment; live entries in it are LOST."""
        for key in [k for k, e in self._index.items() if e.seg == seg]:
            entry = self._index.pop(key)
            self._dead_bytes += entry.nbytes
            self.drops += 1
        self._maps.pop(seg, None)
        path = self._seg_path(seg)
        if os.path.exists(path):
            os.remove(path)
        self._seg_bytes.pop(seg, None)
        self._seg_live.pop(seg, None)

    def _gc_segment(self, seg: int) -> None:
        """Unlink a fully-dead, non-active segment (real disk reclamation)."""
        if seg != self._active and self._seg_live.get(seg, 0) == 0:
            self._drop_segment(seg)

    def _enforce_disk_budget(self) -> None:
        if self.disk_budget_bytes is None:
            return
        while (sum(self._seg_bytes.values()) > self.disk_budget_bytes
               and len(self._seg_bytes) > 1):
            self._drop_segment(min(s for s in self._seg_bytes
                                   if s != self._active))

    # -- write path -----------------------------------------------------------
    def put(self, key, arrays: Dict[str, np.ndarray], meta: dict) -> None:
        """Append one entry (overwriting any previous entry under ``key`` —
        the old record's bytes go dead, log-structured).  ``arrays`` are
        host arrays (see :func:`host_array`)."""
        if self._closed:
            raise RuntimeError("SpillStore is closed")
        if key in self._index:
            self.delete(key)
        descs = []
        payload_bytes = 0
        blobs = []
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            descs.append((name, arr))
            payload_bytes += arr.nbytes
        header = json.dumps({
            "key": repr(key), "meta": meta,
            "arrays": [{"name": n, "dtype": str(a.dtype), "shape": a.shape}
                       for n, a in descs],
        }, default=str).encode()
        prefix = _MAGIC + struct.pack("<I", len(header)) + header
        record = len(prefix) + _pad(len(prefix))
        offsets = []
        for _, arr in descs:
            offsets.append(record)
            record += arr.nbytes + _pad(arr.nbytes)
        if self._seg_bytes[self._active] and \
                self._seg_bytes[self._active] + record > self.segment_bytes:
            self._rotate()
        base = self._seg_bytes[self._active]
        blobs.append(prefix + b"\0" * _pad(len(prefix)))
        for _, arr in descs:
            blobs.append(arr.tobytes() + b"\0" * _pad(arr.nbytes))
        self._fh.write(b"".join(blobs))
        stored = [
            _StoredArray(name=n, dtype=str(a.dtype), shape=tuple(a.shape),
                         offset=base + off, nbytes=a.nbytes)
            for (n, a), off in zip(descs, offsets)
        ]
        self._index[key] = _StoredEntry(seg=self._active, meta=meta,
                                        arrays=stored, nbytes=payload_bytes)
        self._seg_bytes[self._active] = base + record
        self._seg_live[self._active] += 1
        self.writes += 1
        self.bytes_written += payload_bytes
        self._enforce_disk_budget()

    # -- read path ------------------------------------------------------------
    def _segment_map(self, seg: int, need: int) -> np.memmap:
        if seg == self._active:
            self._fh.flush()
        cached = self._maps.get(seg)
        if cached is not None and cached[1] >= need:
            return cached[0]
        size = os.path.getsize(self._seg_path(seg))
        m = np.memmap(self._seg_path(seg), dtype=np.uint8, mode="r",
                      shape=(size,))
        self._maps[seg] = (m, size)
        return m

    def get(self, key) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(meta, arrays) of one entry; arrays are READ-ONLY memmap views
        (zero heap copy — the page cache backs them).  ``KeyError`` when the
        key was never written, deleted, or dropped with its segment."""
        entry = self._index[key]
        arrays: Dict[str, np.ndarray] = {}
        for sa in entry.arrays:
            if sa.nbytes == 0:
                arrays[sa.name] = np.empty(sa.shape, dtype=np.dtype(sa.dtype))
                continue
            m = self._segment_map(entry.seg, sa.offset + sa.nbytes)
            arrays[sa.name] = (m[sa.offset: sa.offset + sa.nbytes]
                               .view(np.dtype(sa.dtype)).reshape(sa.shape))
        self.reads += 1
        self.bytes_read += entry.nbytes
        return entry.meta, arrays

    def __contains__(self, key) -> bool:
        return key in self._index

    def keys(self):
        return list(self._index)

    def delete(self, key) -> None:
        entry = self._index.pop(key, None)
        if entry is None:
            return
        self._dead_bytes += entry.nbytes
        self._seg_live[entry.seg] = self._seg_live.get(entry.seg, 1) - 1
        self._gc_segment(entry.seg)

    # -- lifecycle / introspection --------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "root": self.root,
            "entries": len(self._index),
            "segments": len(self._seg_bytes),
            "live_bytes": sum(e.nbytes for e in self._index.values()),
            "disk_bytes": sum(self._seg_bytes.values()),
            "dead_bytes": self._dead_bytes,
            "writes": self.writes,
            "reads": self.reads,
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
            "drops": self.drops,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fh.close()
        self._maps.clear()
        if self._owns_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def __del__(self) -> None:  # pragma: no cover - interpreter shutdown order
        try:
            self.close()
        except Exception:
            pass


@dataclasses.dataclass
class SpillPolicy:
    """How a store spills: where the log lives and when eviction kicks in.

    ``budget_bytes`` bounds the RESIDENT payload (the tensor spiller's
    budget; the hop-cache keeps its own ``memory_budget_bytes``).  The
    watermarks give eviction hysteresis: spilling starts when resident
    bytes exceed ``high_watermark × budget`` and stops at ``low_watermark ×
    budget``, so a stream of appends pays one burst of spill writes per
    watermark crossing instead of one write per append."""

    store: Optional[SpillStore] = None
    path: Optional[str] = None
    budget_bytes: int = 64 << 20
    high_watermark: float = 1.0
    low_watermark: float = 0.75
    segment_bytes: int = 64 << 20
    disk_budget_bytes: Optional[int] = None

    def ensure_store(self) -> "SpillStore":
        if self.store is None:
            self.store = SpillStore(self.path,
                                    segment_bytes=self.segment_bytes,
                                    disk_budget_bytes=self.disk_budget_bytes)
        return self.store


def resolve_spill(spill) -> Optional[SpillPolicy]:
    """Normalise the ``spill=`` argument both stores accept: ``None``/False
    (disabled), ``True`` (private tempdir, defaults), a path, a
    :class:`SpillStore`, or a full :class:`SpillPolicy`."""
    if spill is None or spill is False:
        return None
    if isinstance(spill, SpillPolicy):
        return spill
    if isinstance(spill, SpillStore):
        return SpillPolicy(store=spill)
    if spill is True:
        return SpillPolicy()
    if isinstance(spill, (str, os.PathLike)):
        return SpillPolicy(path=os.fspath(spill))
    raise TypeError(f"spill must be None/True/path/SpillStore/SpillPolicy, "
                    f"got {type(spill).__name__}")


# ---------------------------------------------------------------------------
# Op-tensor spilling (ProvenanceIndex side)
# ---------------------------------------------------------------------------
class _TensorFault:
    """Stand-in for a spilled op tensor.

    Cheap statistics (shape, nnz, per-slot nnz, payload bytes) answer off
    the spill-time metadata so memory accounting and the cost model's
    :meth:`RelStats.from_slot`-adjacent reads never touch disk; ANY other
    attribute access faults the real tensor back in (one mmap read), swaps
    it into ``op.tensor``, and restores the stripped capture payload."""

    __slots__ = ("_spiller", "_op_id", "_meta")

    def __init__(self, spiller: "TensorSpiller", op_id: int, meta: dict):
        object.__setattr__(self, "_spiller", spiller)
        object.__setattr__(self, "_op_id", op_id)
        object.__setattr__(self, "_meta", meta)

    # -- cheap metadata (no disk) ---------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._spiller.index.device

    @property
    def n_out(self) -> int:
        return int(self._meta["n_out"])

    @property
    def n_in(self) -> tuple:
        return tuple(int(n) for n in self._meta["n_in"])

    @property
    def k(self) -> int:
        return len(self._meta["n_in"])

    @property
    def structured(self) -> bool:
        return "slots" in self._meta

    @property
    def nnz(self) -> int:
        return int(self._meta["nnz"])

    def nbytes(self, include_index: bool = True) -> int:
        return int(self._meta["payload_bytes"])

    def slot_nnz(self, inp: int) -> int:
        return int(self._meta["slot_nnz"][inp])

    def slot_shape(self, inp: int) -> tuple:
        return (self.n_in[inp], self.n_out)

    def slot_density(self, inp: int) -> float:
        cells = self.n_in[inp] * self.n_out
        return self.slot_nnz(inp) / cells if cells else 0.0

    # -- everything else rehydrates -------------------------------------------
    def _fault(self):
        return self._spiller.fault(self._op_id)

    def __getattr__(self, name: str):
        return getattr(self._fault(), name)

    def __repr__(self) -> str:
        return (f"_TensorFault(op_id={self._op_id}, n_out={self.n_out}, "
                f"n_in={self.n_in}, spilled)")


class TensorSpiller:
    """Byte-budgeted residency manager for one index's op tensors.

    ``ProvenanceIndex.record`` notifies it per op; past the high watermark it
    serializes the coldest tensors (LRU by record/fault recency) to the
    spill store, STRIPS the capture-payload aliases off ``op.info`` (the
    structured slots share those arrays — spilling the tensor would free
    nothing otherwise), and leaves a :class:`_TensorFault` in ``op.tensor``.
    A re-spilled tensor whose payload is already on disk skips the write
    (tensors are immutable after capture), so fault/evict ping-pong costs
    one write total.  The store must never drop op segments — a dropped
    tensor is lost provenance — so give the tensor spiller its own store
    with no disk budget (the default)."""

    def __init__(self, index, policy: SpillPolicy) -> None:
        self.index = index
        self.policy = policy
        self.store = policy.ensure_store()
        self._resident: "OrderedDict[int, int]" = OrderedDict()
        self._meta: Dict[int, dict] = {}
        self._stored: set = set()
        self.resident_bytes = 0
        self.spills = 0
        self.rehydrations = 0

    def _key(self, op_id: int):
        return ("op", self.index.name, op_id)

    def on_record(self, op) -> None:
        b = op.tensor.nbytes(include_index=False)
        self._resident[op.op_id] = b
        self.resident_bytes += b
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        budget = self.policy.budget_bytes
        if self.resident_bytes <= budget * self.policy.high_watermark:
            return
        target = budget * self.policy.low_watermark
        while self.resident_bytes > target and len(self._resident) > 1:
            op_id, b = self._resident.popitem(last=False)
            self._spill_op(self.index.ops[op_id], b)

    def _spill_op(self, op, payload_bytes: int) -> None:
        from repro_torch.core.capture import strip_payload  # late: capture is upstream

        if op.op_id not in self._stored:
            meta, tensors = op.tensor.to_payload()
            arrays = {name: host_array(t) for name, t in tensors.items()}
            meta["nnz"] = int(op.tensor.nnz)
            meta["slot_nnz"] = [int(op.tensor.slot_nnz(i))
                                for i in range(op.tensor.k)]
            meta["payload_bytes"] = int(payload_bytes)
            self.store.put(self._key(op.op_id), arrays, meta)
            self._meta[op.op_id] = meta
            self._stored.add(op.op_id)
        strip_payload(op.info)
        op.tensor = _TensorFault(self, op.op_id, self._meta[op.op_id])
        self.resident_bytes -= payload_bytes
        self.spills += 1

    def fault(self, op_id: int):
        """Rehydrate one spilled tensor onto the index's device (one copy of
        each array out of the page cache, one host-to-device copy), payload
        restored onto ``op.info``, residency re-accounted (possibly spilling
        colder ops to stay under the watermark)."""
        from repro_torch.core.capture import restore_payload  # late import
        from repro_torch.core.provtensor import ProvTensor

        op = self.index.ops[op_id]
        if not isinstance(op.tensor, _TensorFault):
            return op.tensor            # another reference already faulted it
        try:
            meta, arrays = self.store.get(self._key(op_id))
        except KeyError:
            raise RuntimeError(
                f"op {op_id} tensor was dropped from the spill store "
                f"({self.store.root}) — op-tensor stores must not set a "
                "disk budget") from None
        tensor = ProvTensor.from_payload(
            meta, {name: device_tensor(a, self.index.device) for name, a in arrays.items()},
            device=self.index.device)
        op.tensor = tensor
        restore_payload(op.info, tensor)
        b = int(meta["payload_bytes"])
        self._resident[op_id] = b
        self.resident_bytes += b
        self.rehydrations += 1
        self._maybe_spill()
        return tensor

    def stats(self) -> Dict[str, object]:
        return {
            "resident_ops": len(self._resident),
            "spilled_ops": len(self.index.ops) - len(self._resident),
            "resident_bytes": self.resident_bytes,
            "budget_bytes": self.policy.budget_bytes,
            "spills": self.spills,
            "rehydrations": self.rehydrations,
            "store": self.store.stats(),
        }
