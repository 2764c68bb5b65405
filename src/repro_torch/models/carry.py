"""Carrying weights across: a parameter tree of numpy arrays in, the port's
modules out.

:func:`lm_params_from_numpy` takes the reference package's LM tree (nested
dicts keyed ``embed``, ``final_norm``, ``blocks``, ``tail{i}``,
``lm_head``) with every leaf a numpy array — block leaves stacked on a
leading ``n_blocks`` axis, an SSD layer's under ``ssd``, a MoE layer's
under ``moe`` with the expert axis after it — and builds the
:class:`~repro_torch.models.lm.LM` holding the same values on ``device``:
block ``j``'s layer ``l{i}`` becomes ``layers[j * len(block) + i]`` and
tail layer ``i`` becomes ``layers[n_blocks * len(block) + i]``.
:func:`whisper_params_from_numpy` takes the encoder-decoder's tree
(``embed``, ``enc_layers`` and ``dec_layers`` stacked on a leading layer
axis, ``enc_norm``, ``final_norm``) and builds the
:class:`~repro_torch.models.whisper.Whisper`: ``enc_layers.{name}[j]``
becomes ``enc_layers.{j}.{name}``.  :func:`params_from_numpy` picks one by
the config.  Every parameter of the port must be given and nothing else
may be; dtypes are kept.  It takes numpy only and reads no other package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.models.whisper import Whisper

__all__ = ["lm_params_from_numpy", "whisper_params_from_numpy", "params_from_numpy"]


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unstack(sub: Mapping, n: int, what: str, layer_name, state: Dict[str, np.ndarray]) -> None:
    """Leaves of ``sub`` stacked on a leading axis of ``n`` -> the state
    entries ``{layer_name(j)}.{name}``."""
    for name, arr in _flatten(sub, "", {}).items():
        if arr.shape[0] != n:
            raise ValueError(f"{what}.{name}: leading axis {arr.shape[0]}, {n} expected")
        for j in range(n):
            state[f"{layer_name(j)}.{name}"] = arr[j]


def _load(module: nn.Module, state: Dict[str, np.ndarray], device) -> nn.Module:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)).to(device) for k, v in state.items()},
        strict=True, assign=True)
    return module


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> LM:
    """The reference's LM parameter tree (numpy leaves) as an ``LM`` on
    ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    per_block = len(cfg.block)
    state: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "blocks":
            for i in range(per_block):
                _unstack(sub[f"l{i}"], cfg.n_blocks, f"blocks.l{i}",
                         lambda j, i=i: f"layers.{j * per_block + i}", state)
        elif key.startswith("tail"):
            layer = cfg.n_blocks * per_block + int(key[len("tail"):])
            _flatten(sub, f"layers.{layer}.", state)
        elif isinstance(sub, Mapping):
            _flatten(sub, f"{key}.", state)
        else:
            state[key] = np.asarray(sub)
    return _load(LM(cfg, device="meta"), state, dev)


def whisper_params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> Whisper:
    """The reference's encoder-decoder parameter tree (numpy leaves) as a
    ``Whisper`` on ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    state: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in ("enc_layers", "dec_layers"):
            n = cfg.enc_layers if key == "enc_layers" else cfg.n_layers
            _unstack(sub, n, key, lambda j, key=key: f"{key}.{j}", state)
        elif isinstance(sub, Mapping):
            _flatten(sub, f"{key}.", state)
        else:
            state[key] = np.asarray(sub)
    return _load(Whisper(cfg, device="meta"), state, dev)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None):
    """The reference's parameter tree of either kind, by ``cfg.is_encdec``."""
    fn = whisper_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
    return fn(cfg, tree, device)
