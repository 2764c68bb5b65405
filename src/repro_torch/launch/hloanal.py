"""Per-device accounting of one eager step, for the roofline analysis.

The port of ``repro.launch.hloanal``.  The reference parses the
post-optimisation HLO text of a compiled step and multiplies each
``while`` body by its trip count, since XLA's own cost analysis counts a
scanned layer once.  An eager torch step has no HLO and no ``while``: it
runs every layer and every microbatch as it goes.  So the port counts the
step while it runs, under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
(:class:`StepCounter`), usually on fake tensors (``FakeTensorMode``) placed
as DTensors on a fake process group, so that nothing is allocated and
nothing communicates.  ``n_while`` is always 0 and ``trip_counts`` empty.

All counts are PER DEVICE, as the reference's (its HLO is the per-partition
SPMD module): an op whose arguments include a ``DTensor`` is left to
DTensor (the counter returns ``NotImplemented``), which runs this rank's
local op and its collectives, and those are counted.  The ops DTensor runs
on global shapes to propagate its metadata (inside a nested entry of the
fake mode) are not counted.

* dot FLOPs: ``torch.utils.flop_counter``'s formulas (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, convolutions, SDPA), which ``FlopCounterMode``
  uses: 2 x the product's output elements x its contraction size.  Einsum
  and ``matmul`` reach aten as these, attention's S x S products included;
* traffic bytes: operand plus result bytes of every aten op that does
  work; views, ``detach``, allocations without a write, ``wait_tensor``
  and metadata queries are skipped, as the reference skips parameters,
  tuples and bitcasts;
* collective bytes: the result bytes of each collective
  (``_c10d_functional`` or ``c10d``) under the reference's five kinds;
  ``collective-permute`` has no eager counterpart and stays 0;
* peak bytes (:attr:`StepCounter.peak_bytes`): the most bytes held at once
  by storages that ops under the counter allocated, freed when their
  storage dies; :attr:`StepCounter.read` holds the storages that some
  counted op read, :attr:`StepCounter.by_group` the collective bytes by
  kind and process group (a mesh dim's group: ``mesh.get_group(dim)``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HloStats", "StepCounter", "analyze_step", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (without namespace and overload) -> kind; the functional
# collectives DTensor issues and the c10d ops torch.distributed issues
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")

# ops that move no bytes: allocations without a write, aliases, waits and
# metadata queries (views are recognised by their schema)
_NO_BYTES = {
    "_c10d_functional::_wrap_tensor_autograd",
    "aten::detach", "aten::alias", "aten::empty", "aten::empty_strided",
    "aten::empty_like", "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh",
    "aten::_local_scalar_dense", "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::sym_storage_offset", "aten::is_contiguous", "aten::is_same_size",
    "aten::is_nonzero", "prim::device", "prim::layout", "_c10d_functional::wait_tensor",
}


@dataclasses.dataclass
class HloStats:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_while: int = 0
    trip_counts: List[int] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict:
        return {
            "dot_flops": self.dot_flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "per_collective": dict(self.per_collective),
            "n_while": self.n_while,
            "trip_counts": list(self.trip_counts),
        }


def _tensors(*trees) -> List[torch.Tensor]:
    """The tensors among an op's arguments or results (tensors, or lists
    and tuples of them: what aten schemas take and return)."""
    out = []
    for x in trees:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _fake_mode():
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


class StepCounter(TorchDispatchMode):
    """Counts the per-device :class:`HloStats` and the peak of newly
    allocated bytes of everything run inside it (see the module's doc)."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = HloStats(per_collective={k: 0.0 for k in COLLECTIVES})
        self.live_bytes = 0
        self.peak_bytes = 0
        self.read: set = set()        # storages some counted op took as input
        # (kind, process group name) -> result bytes of the functional collectives
        self.by_group: Dict[Tuple[str, str], float] = {}
        self._live: Dict[int, int] = {}

    def __enter__(self):
        fake = _fake_mode()
        # DTensor's metadata propagation re-enters the fake mode (or opens a
        # new one): ops seen at a deeper entry are not this rank's work
        self._fake = fake
        self._depth = len(fake.enter_stack) if fake is not None else 0
        return super().__enter__()

    def _propagating(self) -> bool:
        fake = _fake_mode()
        if fake is None:
            return False
        return fake is not self._fake or len(fake.enter_stack) > self._depth

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out: List[torch.Tensor], ins: List[torch.Tensor]) -> None:
        seen = {_storage_key(t) for t in ins}
        for t in out:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs (and we count) the local op
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        ins = _tensors(*args, *kwargs.values())
        outs = _tensors(out)
        self.read.update(_storage_key(t) for t in ins)
        packet = func._overloadpacket
        st = self.stats
        if packet in flop_registry:
            st.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._schema.name
        ns, _, op = name.partition("::")
        kind = _COLLECTIVE_OPS.get(op) if ns in _COLLECTIVE_NAMESPACES else None
        if kind is not None:
            b = _nbytes(outs)
            st.per_collective[kind] += b
            st.collective_bytes += b
            group = ([a for a in args if isinstance(a, str)] or [None])[-1]
            self.by_group[(kind, group)] = self.by_group.get((kind, group), 0.0) + b
        if not func.is_view and name not in _NO_BYTES:
            st.traffic_bytes += _nbytes(ins) + _nbytes(outs)
        if not func.is_view:
            self._track(outs, ins)
        return out


def analyze_step(fn, *args, **kw) -> HloStats:
    """The per-device :class:`HloStats` of one call ``fn(*args, **kw)``."""
    with StepCounter() as counter:
        fn(*args, **kw)
    return counter.stats
