"""Device resolution shared by every entry point of the port.

``device=None`` means the CUDA card.  Where there is none it raises: the
port never carries on silently on the CPU.  Tests and CPU runs pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)`` with a bare ``"cuda"`` pinned to the
    current device index, so device comparisons are exact."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly "
                "to run the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
