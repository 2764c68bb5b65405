"""Async, atomic checkpointing of training state.

The port of ``repro.train.checkpoint``.  Layout per step::

    <dir>/step_000000123.tmp/       (written)
        arrays.npz                  (flat {path: np.ndarray})
        meta.json                   (step, keys, shapes, dtypes, crc)
    <dir>/step_000000123/           (atomic rename on completion)

* ATOMIC: readers only ever see fully written checkpoints (the rename is
  the commit point; stale ``.tmp`` directories of killed writers are
  collected when the next manager opens the directory);
* ASYNC: ``save`` copies every tensor to the host at once (the only
  synchronous cost) and hands the file write to a background thread, at
  most one outstanding;
* INTEGRITY: a CRC32 per array, checked on load;
* RETENTION: the ``keep`` most recent checkpoints, older ones pruned;
* RESTORE ANYWHERE: arrays are saved whole with their logical shapes (a
  DTensor leaf is gathered first, so saving one is collective: every rank
  saves, each into its own directory); ``restore`` places them on any
  device, or with ``shardings=`` distributes them onto any mesh (elastic),
  and casts each to the dtype of the tree it restores into.

Two deviations from the reference's files, neither in the protocol: the
metadata is JSON, not msgpack, and a bfloat16 tensor is stored as its
``uint16`` bit pattern with its true dtype in the metadata (numpy has no
bfloat16 of its own).

A tree is a ``NamedTuple``, a mapping, an ``nn.Module`` (its parameters),
a tensor or ``None`` (no leaves), nested; leaf paths join the keys with
``/`` (a module contributes its parameter names).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.device import resolve_device
from repro_torch.models.common import rebind

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree", "tree_device"]

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_tree(tree: Tree, prefix: str = "",
                 is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Tuple[str, Any]]:
    """``[(path, tensor)]`` in the tree's order; ``is_leaf`` names other
    leaves (a tree of shardings)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, nn.Module):
        return [(f"{prefix}{n}", p) for n, p in tree.named_parameters()]
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, Mapping):
        items = tree.items()
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")
    return [kv for k, v in items for kv in flatten_tree(v, f"{prefix}{k}/", is_leaf)]


def unflatten_tree(like: Tree, leaves: Mapping[str, torch.Tensor], prefix: str = "") -> Tree:
    """A tree shaped as ``like`` holding ``leaves`` (keyed by path)."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return leaves[prefix.rstrip("/")]
    if isinstance(like, nn.Module):
        return rebind(like, {n: leaves[f"{prefix}{n}"] for n, _ in like.named_parameters()})
    if _is_namedtuple(like):
        return type(like)(*(unflatten_tree(v, leaves, f"{prefix}{k}/")
                            for k, v in zip(like._fields, like)))
    return {k: unflatten_tree(v, leaves, f"{prefix}{k}/") for k, v in like.items()}


def tree_device(tree: Tree) -> torch.device:
    """The device of the tree's first leaf."""
    return flatten_tree(tree)[0][1].device


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, whole (a DTensor is gathered: collective);
    bfloat16 as its uint16 bit pattern."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._gc_tmp()

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = False) -> None:
        """Snapshot now (every tensor copied to the host), write in the
        background (or synchronously)."""
        self.wait()  # at most one outstanding writer
        flat = [(k, t.dtype, _host(t)) for k, t in flatten_tree(tree)]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **{k: a for k, _, a in flat})
            meta = {
                "step": step,
                "keys": [k for k, _, _ in flat],
                "crc": {k: _crc(a) for k, _, a in flat},
                "shapes": {k: list(a.shape) for k, _, a in flat},
                "dtypes": {k: str(dt).removeprefix("torch.") for k, dt, _ in flat},
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                  # the commit point
            self._prune()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:  # re-raised by wait() in the caller's thread
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the outstanding writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def restore(self, step: int, like: Tree, device=None, shardings: Tree = None) -> Tree:
        """The checkpoint of ``step`` in the structure of ``like``, every
        leaf on ``device`` (``None``: the card, raising without one) in the
        dtype of ``like``'s leaf at its path.  With ``shardings`` (a tree
        shaped as ``like`` of :class:`~repro_torch.launch.sharding.Sharding`
        leaves) each rank keeps its own shards of each leaf on its mesh: any
        mesh, not only the one that saved (elastic)."""
        dev = resolve_device(device)
        placed = {} if shardings is None else dict(
            flatten_tree(shardings, is_leaf=lambda x: hasattr(x, "placements")))
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        leaves = {}
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            for key, leaf in flatten_tree(like):
                arr = npz[key]
                if _crc(arr) != meta["crc"][key]:
                    raise IOError(f"checksum mismatch for {key} at step {step}")
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(leaf.shape)}")
                if meta["dtypes"][key] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                t = t.to(device=dev, dtype=leaf.dtype)
                if shardings is not None:
                    if key not in placed:
                        raise KeyError(f"no sharding for leaf {key!r}")
                    t = distribute_tensor(t, placed[key].mesh, placed[key].placements,
                                          src_data_rank=None)
                leaves[key] = t
        return unflatten_tree(like, leaves)

    # -- housekeeping ---------------------------------------------------------
    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
