"""Hybrid provenance capture (paper §III-B): CaptureInfo -> ProvTensor.

The hybrid strategy lives in :mod:`repro_torch.dataprep.ops`: index-
preserving ops carry their kept-row lists out of the operation itself, and
the join threads row ids through the merge.  This module only turns those
payloads into the tensors of §III-A, on the payload's device.

Capture emits STRUCTURED tensors by default (identity scalars, gather
slots over the payload, append block offsets); :func:`force_coo_capture`
switches the explicit-COO construction back on for a scope (parity
baselines).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core.opcat import CaptureInfo, IDENTITY_CATEGORIES, OpCategory
from repro_torch.core.provtensor import (
    ProvTensor,
    append_tensor,
    haugment_tensor,
    hreduce_tensor,
    identity_tensor,
    join_tensor,
)

__all__ = ["build_tensor", "force_coo_capture"]

_structured_stack = [True]


@contextlib.contextmanager
def force_coo_capture() -> Iterator[None]:
    """Scope under which capture builds explicit-COO tensors (baselines)."""
    _structured_stack.append(False)
    try:
        yield
    finally:
        _structured_stack.pop()


def build_tensor(info: CaptureInfo, structured: Optional[bool] = None,
                 device=None) -> ProvTensor:
    """The op's provenance tensor.  ``device`` places the tensors that carry
    no payload array (identity, append); the others live where their
    payload lies."""
    if structured is None:
        structured = _structured_stack[-1]
    cat = info.category
    if cat in IDENTITY_CATEGORIES:
        if info.n_out != info.n_in[0]:
            raise ValueError(f"{info.op_name}: identity category but n_out != n_in")
        return identity_tensor(info.n_out, structured=structured, device=device)
    if cat is OpCategory.HREDUCE:
        if info.kept_rows is None:
            raise ValueError(f"{info.op_name}: HREDUCE needs kept_rows")
        return hreduce_tensor(info.kept_rows, info.n_in[0], structured=structured)
    if cat is OpCategory.HAUGMENT:
        if info.links is not None:
            # multi-parent augmentation (sequence packing et al.): raw COO
            return ProvTensor(n_out=info.n_out, n_in=(info.n_in[0],),
                              coo=info.links.to(torch.int32))
        if info.src_rows is None:
            raise ValueError(f"{info.op_name}: HAUGMENT needs src_rows or links")
        return haugment_tensor(info.src_rows, info.n_in[0], structured=structured)
    if cat is OpCategory.JOIN:
        if info.join_pairs is None:
            raise ValueError(f"{info.op_name}: JOIN needs join_pairs")
        return join_tensor(info.join_pairs, info.n_in[0], info.n_in[1],
                           structured=structured)
    if cat is OpCategory.APPEND:
        return append_tensor(info.n_in[0], info.n_in[1], structured=structured,
                             device=device)
    raise ValueError(f"unknown category {cat}")
