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
may be; dtypes are kept (a bfloat16 leaf, which numpy holds only through
an extension dtype, is read through its 16-bit pattern).  It takes numpy
only and reads no other package.

The other way, :func:`params_to_numpy` turns the port's module, or any
tensors keyed by its parameter names (the optimizer's moments), back into
the reference's nested tree, blocks stacked again and a norm without
parameters an empty dict; :func:`named_from_numpy` carries such a tree in
as tensors keyed by the port's parameter names, which is how moments cross.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.common import Norm
from repro_torch.models.lm import LM
from repro_torch.models.whisper import Whisper

__all__ = ["lm_params_from_numpy", "whisper_params_from_numpy", "params_from_numpy",
           "named_from_numpy", "params_to_numpy", "reference_path"]


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


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; a bfloat16 array (an extension dtype
    of numpy) through its bit pattern."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _load(module: nn.Module, state: Dict[str, np.ndarray], device) -> nn.Module:
    module.load_state_dict({k: _tensor(v, device) for k, v in state.items()},
                           strict=True, assign=True)
    return module


def _lm_state(cfg: ModelConfig, tree: Mapping) -> Dict[str, np.ndarray]:
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
    return state


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> LM:
    """The reference's LM parameter tree (numpy leaves) as an ``LM`` on
    ``device`` (``None``: the card, raising without one)."""
    return _load(LM(cfg, device="meta"), _lm_state(cfg, tree), resolve_device(device))


def _whisper_state(cfg: ModelConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    state: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in ("enc_layers", "dec_layers"):
            n = cfg.enc_layers if key == "enc_layers" else cfg.n_layers
            _unstack(sub, n, key, lambda j, key=key: f"{key}.{j}", state)
        elif isinstance(sub, Mapping):
            _flatten(sub, f"{key}.", state)
        else:
            state[key] = np.asarray(sub)
    return state


def whisper_params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> Whisper:
    """The reference's encoder-decoder parameter tree (numpy leaves) as a
    ``Whisper`` on ``device`` (``None``: the card, raising without one)."""
    return _load(Whisper(cfg, device="meta"), _whisper_state(cfg, tree), resolve_device(device))


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None):
    """The reference's parameter tree of either kind, by ``cfg.is_encdec``."""
    fn = whisper_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
    return fn(cfg, tree, device)


def named_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """A tree shaped as the reference's parameters (e.g. an Adam moment) as
    tensors on ``device`` (``None``: the card, raising without one), keyed
    by the port's parameter names in the module's order; dtypes kept."""
    state = _whisper_state(cfg, tree) if cfg.is_encdec else _lm_state(cfg, tree)
    names = [n for n, _ in (Whisper if cfg.is_encdec else LM)(cfg, device="meta")
             .named_parameters()]
    if set(names) != set(state):
        raise ValueError(f"tree leaves {sorted(set(state) ^ set(names))} do not match the model")
    dev = resolve_device(device)
    return {n: _tensor(state[n], dev) for n in names}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """float32 for bfloat16 (exact), which numpy cannot hold by itself."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def reference_path(cfg: ModelConfig, name: str) -> Tuple[List[str], Optional[int]]:
    """The reference's tree path of a port parameter or module name, and
    the index on the path's stacked leading axis (``None`` off the stacks):
    ``layers.{k}`` of block ``j`` is ``blocks/l{k - j * len(block)}`` at
    ``j``, a tail layer is ``tail{i}``, ``enc_layers.{j}`` is
    ``enc_layers`` at ``j``."""
    parts = name.split(".")
    if parts[0] in ("enc_layers", "dec_layers"):
        return [parts[0], *parts[2:]], int(parts[1])
    if parts[0] == "layers":
        per_block = len(cfg.block)
        n_stacked = cfg.n_blocks * per_block
        k = int(parts[1])
        if k < n_stacked:
            j, i = divmod(k, per_block)
            return ["blocks", f"l{i}", *parts[2:]], j
        return [f"tail{k - n_stacked}", *parts[2:]], None
    return parts, None


def params_to_numpy(cfg: ModelConfig,
                    params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """The inverse of :func:`params_from_numpy`: the port's module, or
    tensors keyed by its parameter names, as the reference's nested tree of
    numpy arrays (bfloat16 as float32, exactly), the layers stacked on the
    reference's leading axes again and each norm without parameters an
    empty dict."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    layout = (Whisper if cfg.is_encdec else LM)(cfg, device="meta")
    path_of = functools.partial(reference_path, cfg)
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    tree: Dict = {}
    for mod_name, mod in layout.named_modules():
        if isinstance(mod, Norm) and mod.scale is None:
            _put(tree, path_of(mod_name)[0], {})
    for name in (n for n, _ in layout.named_parameters()):
        path, j = path_of(name)
        if j is None:
            _put(tree, path, _numpy(named[name]))
        else:
            stacks.setdefault(tuple(path), {})[j] = _numpy(named[name])
    for path, by_index in stacks.items():
        _put(tree, list(path), np.stack([by_index[j] for j in sorted(by_index)]))
    return tree
