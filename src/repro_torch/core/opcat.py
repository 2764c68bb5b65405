"""Operation taxonomy (paper Table I / Section II) and capture payloads.

Attribute maps are schema-level: their bitsets, permutation lists and
packed attribute planes stay on the host as CPU tensors (at most a few
hundred bits each).  The record-level payload of a :class:`CaptureInfo`
(``kept_rows``, ``src_rows``, ``join_pairs``, ``links``) lies on the device
of the table the op ran on.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.provtensor import pack_pairs
from repro_torch.core.schema import Bitset, rank_positions

__all__ = ["OpCategory", "IDENTITY_CATEGORIES", "AttrMap", "CaptureInfo"]


class OpCategory(enum.Enum):
    TRANSFORM = "data_transformation"
    VREDUCE = "vertical_reduction"
    VAUGMENT = "vertical_augmentation"
    HREDUCE = "horizontal_reduction"
    HAUGMENT = "horizontal_augmentation"
    JOIN = "join"
    APPEND = "append"


# Categories whose record-level tensor is the 2-D identity (paper §III-A).
IDENTITY_CATEGORIES = (OpCategory.TRANSFORM, OpCategory.VREDUCE, OpCategory.VAUGMENT)


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


@dataclasses.dataclass
class AttrMap:
    """Attribute mapping between ONE input schema and the output schema.

    ``kind``:
      * 'identity'  — positional identity (no bitset stored; paper §IV)
      * 'vreduce'   — ``bitset`` over input attrs (1 = kept)
      * 'vaugment'  — ``bitset`` over output attrs (first m = inputs used to
                       engineer, bits >= m = the new attrs), ``m`` = #input attrs
      * 'join'      — ``bitset`` over output attrs (1 = from this input);
                       ``perm`` optional explicit output-attr -> input-attr list
    """

    kind: str
    bitset: Optional[Bitset] = None
    m: Optional[int] = None
    perm: Optional[torch.Tensor] = None  # int32 (n_out_attrs,), -1 = not from here
    # cached packed attribute bitplanes, keyed (direction, n_in, n_out):
    _planes: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def nbytes(self) -> int:
        total = 0
        if self.bitset is not None:
            total += self.bitset.nbytes()
        if self.perm is not None:
            total += int(self.perm.numel() * self.perm.element_size())
        for plane in self._planes.values():
            total += int(plane.numel() * plane.element_size())
        return total

    def pairs(self, n_in: int, n_out: int):
        """The attribute relation as an (in_attr, out_attr) int32 edge list."""
        if self.kind == "identity":
            i = torch.arange(min(n_in, n_out), dtype=torch.int32)
            return i, i
        if self.kind == "vreduce":
            if self.perm is not None:  # order-changing fallback (paper: int list)
                perm = _i32(self.perm)
                return perm, torch.arange(len(perm), dtype=torch.int32)
            rp = rank_positions(self.bitset)
            kept = torch.nonzero(rp >= 0).reshape(-1).to(torch.int32)
            return kept, rp[kept.long()]
        if self.kind == "vaugment":
            m = self.m
            new = self.bitset.indices().to(torch.int32)
            eng = new[new < m]          # input attrs used to engineer features
            new = new[new >= m]         # the engineered output attrs
            i = torch.arange(min(m, n_out), dtype=torch.int32)
            return (
                torch.cat([i, torch.repeat_interleave(eng, len(new))]),
                torch.cat([i, new.repeat(len(eng))]),
            )
        if self.kind == "join":
            if self.perm is not None:
                perm = _i32(self.perm)
                out = torch.nonzero(perm >= 0).reshape(-1).to(torch.int32)
                return perm[out.long()], out
            outpos = self.bitset.indices().to(torch.int32)
            k = min(n_in, len(outpos))
            return torch.arange(k, dtype=torch.int32), outpos[:k]
        raise ValueError(self.kind)

    def fwd_plane(self, n_in: int, n_out: int) -> torch.Tensor:
        """int32 (n_in, max(ceil(n_out/32), 1)): row i = packed output attrs
        fed by input attr i.  Memoized per shape."""
        key = ("f", n_in, n_out)
        if key not in self._planes:
            i, o = self.pairs(n_in, n_out)
            self._planes[key] = pack_pairs(i, o, n_in, n_out, min_words=1)
        return self._planes[key]

    def bwd_plane(self, n_in: int, n_out: int) -> torch.Tensor:
        """int32 (n_out, max(ceil(n_in/32), 1)): the transposed relation."""
        key = ("b", n_in, n_out)
        if key not in self._planes:
            i, o = self.pairs(n_in, n_out)
            self._planes[key] = pack_pairs(o, i, n_out, n_in, min_words=1)
        return self._planes[key]


@dataclasses.dataclass
class CaptureInfo:
    """Everything an operation hands to the provenance index at capture time."""

    op_name: str                       # e.g. 'filter', 'onehot', 'join'
    category: OpCategory
    contextual: bool                   # paper §III-E materialization policy
    n_out: int
    n_in: List[int]
    # record-level link payload (exactly one of these per category), int32
    # tensors on the table's device:
    kept_rows: Optional[torch.Tensor] = None    # HREDUCE: out i <- in kept[i]
    src_rows: Optional[torch.Tensor] = None     # HAUGMENT: out i <- in src[i] (-1 ok)
    join_pairs: Optional[torch.Tensor] = None   # JOIN: (n_out, 2), -1 for outer dangles
    links: Optional[torch.Tensor] = None        # HAUGMENT multi-parent: (nnz, 2) of
                                                # (out_row, in_row)
    # schema-level (prospective) annotations, one per input:
    attr_maps: List[AttrMap] = dataclasses.field(default_factory=list)
    # recomputation closure: op params needed to re-execute on a subset of rows
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
