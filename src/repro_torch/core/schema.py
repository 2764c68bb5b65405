"""Prospective schema metadata: attribute bitsets (paper Table VI).

A bitset costs one 32-bit word per 32 attributes; :func:`rank_positions`
realizes the rank-based attribute maps of Section IV for every position at
once.

Attribute bitsets hold at most a few hundred bits, so they stay on the host
as CPU tensors whatever the index's device: moving them to the card would
cost a launch per map and save nothing.  Words are int32 (see
:mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ref import pack_bits, popcount32, unpack_bits

__all__ = ["Bitset", "rank_positions"]


@dataclasses.dataclass(frozen=True)
class Bitset:
    """Packed little-endian bitset over attribute positions [0, n)."""

    n: int
    words: torch.Tensor  # int32 (max(ceil(n/32), 1),) on the CPU

    @staticmethod
    def from_bits(bits) -> "Bitset":
        bits = torch.as_tensor(bits, dtype=torch.bool).reshape(-1).cpu()
        n = int(bits.shape[0])
        nw = max((n + 31) // 32, 1)
        padded = torch.zeros(nw * 32, dtype=torch.bool)
        padded[:n] = bits
        return Bitset(n=n, words=pack_bits(padded[None, :])[0])

    @staticmethod
    def from_indices(indices, n: int) -> "Bitset":
        bits = torch.zeros(n, dtype=torch.bool)
        bits[torch.as_tensor(list(indices), dtype=torch.int64)] = True
        return Bitset.from_bits(bits)

    @staticmethod
    def from_string(s: str) -> "Bitset":
        """Paper notation, e.g. '10011' = attrs 0, 3, 4 set."""
        return Bitset.from_bits([c == "1" for c in s])

    def to_bits(self) -> torch.Tensor:
        return unpack_bits(self.words[None, :], self.n)[0]

    def test(self, i: int) -> bool:
        return bool((int(self.words[i // 32]) >> (i % 32)) & 1)

    def rank(self, i: int) -> int:
        """Number of set bits in positions [0, i] (inclusive) — paper's
        ``sum_{k<=i} b_k``."""
        if i < 0:
            return 0
        i = min(i, self.n - 1)
        return int(self.to_bits()[: i + 1].sum())

    def select(self, r: int) -> Optional[int]:
        """Position of the r-th (1-based) set bit, or None."""
        if r <= 0:
            return None
        idx = self.indices()
        return int(idx[r - 1]) if r <= len(idx) else None

    def popcount(self) -> int:
        return int(popcount32(self.words).sum())

    def indices(self) -> torch.Tensor:
        return torch.nonzero(self.to_bits()).reshape(-1)

    def __str__(self) -> str:  # paper notation
        return "".join("1" if b else "0" for b in self.to_bits().tolist())

    def nbytes(self) -> int:
        return int(self.words.numel() * self.words.element_size())


def rank_positions(b: Bitset) -> torch.Tensor:
    """Vectorized rank map: int32 (n,) with entry ``rank(i) - 1`` where bit i
    is set and ``-1`` elsewhere — ``map_vr_f`` (vreduce bitset) or
    ``map_join_b`` (join bitset) at every position at once."""
    bits = b.to_bits()
    ranks = torch.cumsum(bits.to(torch.int64), dim=0) - 1
    return torch.where(bits, ranks, torch.full_like(ranks, -1)).to(torch.int32)

