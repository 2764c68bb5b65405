"""Carrying LM weights across: a parameter tree of numpy arrays in, the
port's modules out.

:func:`lm_params_from_numpy` takes the reference package's parameter tree
(nested dicts keyed ``embed``, ``final_norm``, ``blocks``, ``tail{i}``,
``lm_head``) with every leaf a numpy array — block leaves stacked on a
leading ``n_blocks`` axis — and builds the :class:`~repro_torch.models.lm.LM`
holding the same values on ``device``: block ``j``'s layer ``l{i}`` becomes
``layers[j * len(block) + i]`` and tail layer ``i`` becomes
``layers[n_blocks * len(block) + i]``.  Every parameter of the port must be
given and nothing else may be; dtypes are kept.  It takes numpy only and
reads no other package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import LM

__all__ = ["lm_params_from_numpy"]


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> LM:
    """The reference's LM parameter tree (numpy leaves) as an ``LM`` on
    ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    per_block = len(cfg.block)
    state: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "blocks":
            for i in range(per_block):
                for name, arr in _flatten(sub[f"l{i}"], "", {}).items():
                    if arr.shape[0] != cfg.n_blocks:
                        raise ValueError(f"blocks.l{i}.{name}: leading axis {arr.shape[0]}, "
                                         f"{cfg.n_blocks} blocks")
                    for j in range(cfg.n_blocks):
                        state[f"layers.{j * per_block + i}.{name}"] = arr[j]
        elif key.startswith("tail"):
            layer = cfg.n_blocks * per_block + int(key[len("tail"):])
            _flatten(sub, f"layers.{layer}.", state)
        elif isinstance(sub, Mapping):
            _flatten(sub, f"{key}.", state)
        else:
            state[key] = np.asarray(sub)
    params = LM(cfg, device="meta")
    params.load_state_dict(
        {k: torch.from_numpy(np.array(v)).to(dev) for k, v in state.items()},
        strict=True, assign=True)
    return params
