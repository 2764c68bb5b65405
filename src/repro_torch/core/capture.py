"""Hybrid provenance capture (paper §III-B): CaptureInfo -> ProvTensor.

The hybrid strategy lives in :mod:`repro_torch.dataprep.ops`: index-
preserving ops carry their kept-row lists out of the operation itself, and
the join threads row ids through the merge.  This module only turns those
payloads into the tensors of §III-A, on the payload's device.

Capture emits STRUCTURED tensors by default (identity scalars, gather
slots over the payload, append block offsets); :func:`force_coo_capture`
switches the explicit-COO construction back on for a scope (parity
baselines).  :func:`strip_payload` / :func:`restore_payload` drop and
rebuild the capture payload aliases of an op whose tensor the spill tier
(:mod:`repro_torch.core.spill`) moved to disk.
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

__all__ = ["build_tensor", "force_coo_capture", "structured_capture_enabled",
           "strip_payload", "restore_payload"]

_structured_stack = [True]


def structured_capture_enabled() -> bool:
    """Whether :func:`build_tensor` currently emits structured tensors."""
    return _structured_stack[-1]


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


# ---------------------------------------------------------------------------
# Spill-tier payload stripping (repro_torch.core.spill.TensorSpiller)
# ---------------------------------------------------------------------------
def _slot_column(tensor: ProvTensor, slot: int) -> torch.Tensor:
    g = tensor.slot_gather(slot)
    return g if g is not None else tensor.coo[:, 1 + slot]


def strip_payload(info: CaptureInfo) -> None:
    """Drop the capture payload tensors off ``info`` when the op's tensor is
    spilled.  The structured slots hold these very tensors BY REFERENCE
    (``kept_rows`` IS the gather slot's payload), so spilling the tensor
    frees no device memory while the info-side alias survives.  Which
    fields were stripped is remembered on the record so
    :func:`restore_payload` puts back exactly what existed — a COO
    HAUGMENT tensor alone cannot tell a stripped ``src_rows`` from
    stripped multi-parent ``links``."""
    stripped = []
    for field in ("kept_rows", "src_rows", "join_pairs", "links"):
        if getattr(info, field) is not None:
            setattr(info, field, None)
            stripped.append(field)
    info._spill_stripped = tuple(stripped)


def restore_payload(info: CaptureInfo, tensor: ProvTensor) -> None:
    """Inverse of :func:`strip_payload`, rebuilding the payload fields from
    a rehydrated tensor, value for value: the tensor constructors stored
    these exact arrays per slot at capture time."""
    for field in getattr(info, "_spill_stripped", ()):
        if field == "kept_rows":
            info.kept_rows = _slot_column(tensor, 0)
        elif field == "src_rows":
            info.src_rows = _slot_column(tensor, 0)
        elif field == "join_pairs":
            g0 = tensor.slot_gather(0)
            if g0 is not None:
                info.join_pairs = torch.stack([g0, tensor.slot_gather(1)], dim=1)
            else:
                info.join_pairs = tensor.coo[:, 1:3]
        elif field == "links":
            info.links = tensor.coo
    info._spill_stripped = ()
