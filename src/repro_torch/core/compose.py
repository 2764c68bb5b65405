"""Chains of op tensors between two datasets (paper §IV).

Only :func:`path_tensors` is ported so far: the fused walk's linearity
audit needs it.  The composition itself (bit-packed boolean matmul, the
chain planner, the sparse backend) belongs to the hop-cache slice
(ROADMAP A5).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.pipeline import OpRecord, ProvenanceIndex

__all__ = ["path_tensors"]


def path_tensors(index: ProvenanceIndex, src: str, dst: str) -> List[Tuple[OpRecord, int]]:
    """The op chain linking ``src`` to ``dst``: [(op, input_slot), ...].

    Follows the (unique-producer) dataflow backward from ``dst`` and keeps
    the ops on a path that reaches ``src``; for multi-input ops the slot
    records WHICH input lies on the path.  The reachable-from-``src`` set is
    computed once up front.
    """
    reach = {src}
    for op in index.ops:
        if any(d in reach for d in op.input_ids):
            reach.add(op.output_id)
    chain: List[Tuple[OpRecord, int]] = []
    cur = dst
    while cur != src:
        if cur not in index.producer:
            raise KeyError(f"no dataflow path {src} -> {dst} (stuck at {cur})")
        op = index.ops[index.producer[cur]]
        slot = None
        for k, in_id in enumerate(op.input_ids):
            if in_id in reach:
                slot = k
                break
        if slot is None:
            raise KeyError(f"no dataflow path {src} -> {dst} (op {op.info.op_name})")
        chain.append((op, slot))
        cur = op.input_ids[slot]
    return list(reversed(chain))
