"""The assigned input-shape cells and their meta-device stand-ins.

The port of ``repro.launch.shapes``.  Four shapes per architecture (40
cells in all):

    train_4k      seq 4096,    global_batch 256   -> the train step
    prefill_32k   seq 32768,   global_batch 32    -> prefill
    decode_32k    seq 32768,   global_batch 128   -> the decode step
    long_500k     seq 524288,  global_batch 1     -> the decode step

``long_500k`` needs a sub-quadratic mechanism: it runs for ssm/hybrid
(constant-size SSD state) and for gemma3's 5:1 local:global interleave
(bounded window caches), and is skipped for pure full-attention stacks.

``input_specs`` and ``cache_specs`` return tensors on the ``meta`` device
(shape and dtype, no storage): nothing is ever allocated for the full
configs.  The port's cache is a list with one dict per layer (the
reference stacks the block's layers on a leading axis).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.registry import get_config

__all__ = ["SHAPES", "ShapeCell", "input_specs", "cache_specs", "cell_skip_reason",
           "all_cells", "n_micro", "q_chunk"]

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs with a sub-quadratic mechanism (bounded state or bounded window)
_LONG_OK = {"mamba2-370m", "jamba-1.5-large-398b", "gemma3-12b", "gemma3-1b"}

_ARCH_ORDER = [
    "gemma3-12b", "llama3-405b", "gemma3-1b", "olmo-1b", "whisper-small",
    "qwen3-moe-235b-a22b", "dbrx-132b", "mamba2-370m",
    "jamba-1.5-large-398b", "chameleon-34b",
]


def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in _LONG_OK:
        return ("pure full attention on every layer: no sub-quadratic "
                "mechanism for a 500k-token cache (DESIGN.md §6)")
    return None


def all_cells() -> Iterator[Tuple[str, str]]:
    for arch in _ARCH_ORDER:
        for shape in SHAPES:
            yield arch, shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: str, shape: str) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of this cell."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32

    if cell.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, s), i32)}
        if cell.kind == "train":
            specs["labels"] = _meta((b, s), i32)
        if cfg.is_encdec:
            specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        return specs

    # decode: one new token against an S-long cache
    return {"token": _meta((b,), i32), "pos": _meta((), i32)}


def cache_specs(arch: str, shape: str):
    """The decode cache of a decode cell, on the meta device."""
    from repro_torch.models.registry import get_model

    cfg = get_config(arch)
    cell = SHAPES[shape]
    return get_model(cfg).init_cache(cfg, cell.global_batch, cell.seq_len,
                                     dtype=torch.bfloat16, device=META)


# per-(arch, shape) knobs: microbatch count + query chunking, the
# reference's choices for its per-device activation footprint
_N_MICRO = {
    ("llama3-405b", "train_4k"): 16,
    ("jamba-1.5-large-398b", "train_4k"): 16,
    ("chameleon-34b", "train_4k"): 8,
    ("dbrx-132b", "train_4k"): 8,
    ("qwen3-moe-235b-a22b", "train_4k"): 8,
    ("gemma3-12b", "train_4k"): 4,
    ("whisper-small", "train_4k"): 16,
}


def n_micro(arch: str, shape: str) -> int:
    return _N_MICRO.get((arch, shape), 2 if shape == "train_4k" else 1)


def q_chunk(arch: str, shape: str) -> int:
    cell = SHAPES[shape]
    if cell.kind in ("train", "prefill") and cell.seq_len > 8192:
        return 2048
    return 0
