"""Public kernel entry points: operand checks, device dispatch, launch counts.

Dispatch is by the device of the operands, never by a flag:

* CPU tensors take the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* CUDA tensors take the hand-written kernel, or the call raises (no card
  of capability (9, 0), a failed build or launch, a frontier too wide for
  shared memory).  Nothing falls back to the plain version.

``launch_counts()`` counts the dispatches of each entry: on CUDA the launch
of the kernel, counted right after it was accepted; on the CPU the call of
its plain version, the CPU's stand-in for the kernel.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.batched_walk import batched_walk_cuda

__all__ = ["batched_walk", "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {}


def _note_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict:
    """{kernel entry: dispatch count} since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _check_walk_chain(mask_bits: torch.Tensor, planes: Sequence[torch.Tensor]) -> None:
    kw = mask_bits.shape[1]
    for j, plane in enumerate(planes):
        rows = plane.shape[0]
        if not ((kw - 1) * 32 < rows <= kw * 32):
            raise ValueError(
                f"hop {j}: frontier packs {kw * 32} cols, plane has {rows} rows"
            )
        kw = plane.shape[1]


def batched_walk(mask_bits: torch.Tensor, planes: Sequence[torch.Tensor]):
    """K-hop batched record probe in ONE kernel launch.

    ``mask_bits`` (B, ceil(n_0/32)) int32 packs B probe sets over the chain's
    entry dim; ``planes[j]`` is hop j's packed (n_j, ceil(n_{j+1}/32)) int32
    relation bitplane.  Returns ``(out_bits (B, ceil(n_K/32)) int32, counts
    (K, B) int32)``: the final frontier and each hop's per-probe frontier
    size.
    """
    planes = list(planes)
    if not planes:
        raise ValueError("batched_walk needs at least one hop")
    _check_walk_chain(mask_bits, planes)
    devices = {t.device for t in (mask_bits, *planes)}
    if len(devices) != 1:
        raise ValueError(f"batched_walk operands lie on several devices: {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        _note_launch("batched_walk")
        return ref.batched_walk_ref(mask_bits, planes)
    if dev.type != "cuda":
        raise ValueError(f"batched_walk has no kernel for device {dev}")
    out = batched_walk_cuda(mask_bits, planes)
    _note_launch("batched_walk")
    return out
