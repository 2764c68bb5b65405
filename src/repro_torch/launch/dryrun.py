"""Multi-pod dry run: account for every (arch x shape x mesh) cell.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
the FULL config of each cell with XLA on 256 (16 x 16) or 512
(2 x 16 x 16) placeholder devices and reads the compiled module's memory
and cost analyses.  The port has no compiler to ask: it runs one step of
the cell eagerly, in one process, on meta tensors (shapes and dtypes, no
storage) placed as DTensors by :mod:`repro_torch.launch.sharding` on a
mesh over a FAKE process group (``torch.distributed``'s ``"fake"``
backend: collectives return at once), and counts what rank 0 does as it
runs (:class:`~repro_torch.launch.hloanal.StepCounter`).  The multi-pod
mesh is accounted as its (pod x data, model) flattening
(:func:`_joint_fsdp`).

A cell's record keeps the reference's keys:

* ``status`` (``ok``, ``skip`` with the reason of
  :func:`~repro_torch.launch.shapes.cell_skip_reason`, or ``fail`` with the
  error);
* ``compile_s``: the seconds the accounting took (there is no compile);
  ``extrapolated``: whether the step was accounted at a few blocks and
  microbatches and extended to the config's (``lower_cell(extrapolate=)``:
  every cell of a decoder-only model with more than three blocks or
  microbatches);
* ``memory``: per device, ``argument_size_in_bytes`` (the local shards of
  the step's inputs that it reads: state and batch, params and tokens,
  params, cache, token and position; an input the step never reads is no
  argument, as ``jax.jit`` drops unused arguments),
  ``output_size_in_bytes`` (the local shards of what it returns) and
  ``temp_size_in_bytes`` (the most bytes the step's own allocations
  held at once, its outputs included: the port's steps are functional and
  donate nothing); ``generated_code_size_in_bytes`` has no counterpart and
  is omitted;
* ``cost``: ``{"flops": dot FLOPs, "bytes_accessed": traffic bytes}``;
* ``collectives``: the result bytes of each of the five collective kinds;
* ``hlo``: :class:`~repro_torch.launch.hloanal.HloStats` as a dict.

Nothing happens at import: no environment variable is set and no process
group is opened.  :func:`run_dryrun` (and :func:`fake_production_mesh`)
open the fake world and destroy it again.  A decode cell runs
``decode_step`` at the cache's last position (the work does not depend on
it: the step attends over the whole cache under a mask).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device-type cpu \
        --arch olmo-1b --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.registry import get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch import shapes as SH
from repro_torch.launch import sharding as SD
from repro_torch.launch.hloanal import COLLECTIVES, HloStats, StepCounter
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models import lm, pshard as PS, whisper
from repro_torch.models.common import trainable
from repro_torch.models.registry import get_model
from repro_torch.train.checkpoint import flatten_tree
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import TrainState, make_train_step

__all__ = ["lower_cell", "run_cell", "run_dryrun", "collective_bytes", "CellAccount",
           "MemoryAnalysis", "fake_production_mesh"]

_WORLD = {"single": 256, "multi": 512}


def _act_policy(mesh) -> dict:
    """Default activation policy: batch over (pod,data), width over model
    (``mesh``: a ``DeviceMesh`` or ``{axis: size}``).

    moe_groups = |data shards|: MoE dispatch sorts within each data shard
    (local argsort) instead of one global sort (see models/moe.py).
    """
    fs = SD.fsdp_axes(mesh)
    sizes = SD._shape(mesh)
    dp_size = 1
    for a in fs:
        dp_size *= sizes[a]
    return {"dp": fs or None, "tp": SD.tp_axis(mesh), "moe_groups": dp_size}


def _fit_n_micro(requested: int, global_batch: int, mesh,
                 layout: str = "fsdp_tp") -> int:
    """Largest n_micro <= requested with (batch/n_micro) divisible by |dp|
    (a microbatch smaller than the data axis forces GSPMD to replicate)."""
    dp_axes, _ = SD.layout_axes(mesh, layout)
    sizes = SD._shape(mesh)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    nm = max(1, min(requested, global_batch))
    while nm > 1 and (global_batch % nm or (global_batch // nm) % dp):
        nm -= 1
    return nm


def collective_bytes(stats: HloStats) -> Dict[str, int]:
    """Result bytes per collective kind of one accounted step."""
    return {k: int(stats.per_collective.get(k, 0)) for k in COLLECTIVES}


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_production_mesh(mesh_name: str, device_type: str = "cuda") -> Iterator[Any]:
    """The production mesh (``"single"``: 16 x 16, ``"multi"``: 2 x 16 x 16)
    over a fake process group of 256 or 512 ranks, this process rank 0;
    the group is destroyed on exit.  ``device_type="cuda"`` (the default)
    needs a card and raises without one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if device_type == "cuda":
        resolve_device(None)
    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry run opens its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=_WORLD[mesh_name])
    try:
        yield make_production_mesh(multi_pod=mesh_name == "multi", device_type=device_type)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Cell accounting
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """Per-device bytes of one cell (the fields of XLA's memory analysis)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int


@dataclasses.dataclass
class CellAccount:
    """What :func:`lower_cell` counted for one cell on one mesh."""

    arch: str
    shape: str
    n_micro: int
    stats: HloStats
    memory: MemoryAnalysis
    seconds: float
    extrapolated: bool = False

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory


def _local_bytes(tree, read=None) -> int:
    """Bytes of the tree's local shards (only those whose storage is in
    ``read``, when given)."""
    shards = (t.to_local() if isinstance(t, DTensor) else t for _, t in flatten_tree(tree))
    return sum(t.numel() * t.element_size() for t in shards
               if read is None or t.untyped_storage()._cdata in read)


def _joint_fsdp(mesh):
    """The multi-pod mesh as (pod x data, model) named ("data", "model").

    Every rule of :mod:`~repro_torch.launch.sharding` splits over "pod"
    only together with "data" (pod-major), so the flattened mesh splits
    every tensor as the 3-D one does; its FSDP collectives run over the
    joint axis in one call, as XLA's do over the joint device group, where
    DTensor on the 3-D mesh issues one per mesh dim (and plans them
    slowly)."""
    names = list(mesh.mesh_dim_names)
    if names[:2] != ["pod", "data"]:
        return mesh
    ranks = mesh.mesh.reshape(-1, *mesh.mesh.shape[2:])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("data", *names[2:]))


def _placed(tree, specs, mesh):
    return SD.place(tree, SD.to_shardings(specs, mesh))


def _meta_params(cfg):
    """The full config's float32 parameters on the meta device."""
    return (whisper.Whisper if cfg.is_encdec else lm.LM)(cfg, device="meta")


def _inputs(arch: str, shape: str, global_batch: int) -> Dict[str, torch.Tensor]:
    """``input_specs`` of the cell, its batch axis resized to ``global_batch``."""
    ins = SH.input_specs(arch, shape)
    return {k: (v if v.ndim == 0 else
                torch.empty((global_batch,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta"))
            for k, v in ins.items()}


def _account(arch: str, shape: str, cfg, mesh, gb: int, nm: int, opt_cfg: AdamWConfig,
             policy: dict, layout: str):
    """One step of ``cfg`` at global batch ``gb`` in ``nm`` microbatches,
    counted: (HloStats, MemoryAnalysis)."""
    cell = SH.SHAPES[shape]
    model = get_model(cfg)
    qc = SH.q_chunk(arch, shape)
    params = _meta_params(cfg)
    ins = _inputs(arch, shape, gb)
    if cell.kind == "train":
        # gradients accumulate in the parameters' dtype (train.trainer)
        params = trainable(params.to(opt_cfg.accum_dtype))
        state = TrainState(params, init_opt_state(params, opt_cfg))
    elif cell.kind == "decode":
        cache = model.init_cache(cfg, gb, cell.seq_len, dtype=torch.bfloat16, device="meta")
    pos_bytes = 0
    with use_mesh(mesh), PS.use_policy(policy):
        if cell.kind == "train":
            state = _placed(state, SD.state_pspecs(cfg, state, mesh, layout), mesh)
            batch = _placed(ins, SD.batch_pspecs(ins, mesh, layout), mesh)
            step = make_train_step(cfg, opt_cfg, n_micro=nm, q_chunk=qc)
            args = (state, batch)
            with StepCounter() as counter:
                out = step(state, batch)
        elif cell.kind == "prefill":
            p = _placed(params, SD.param_pspecs(cfg, params, mesh, layout), mesh)
            x = _placed(ins, SD.batch_pspecs(ins, mesh, layout), mesh)
            args = (p, x)
            with implicit_replication(), StepCounter() as counter:
                if cfg.is_encdec:
                    out = model.prefill(cfg, p, x["frames"], x["tokens"], q_chunk=qc)
                else:
                    out = model.prefill(cfg, p, x["tokens"], q_chunk=qc)
        else:  # decode
            p = _placed(params, SD.param_pspecs(cfg, params, mesh, layout), mesh)
            specs = SD.cache_pspecs(cache, mesh)
            layers = _placed(dict(enumerate(cache)), dict(enumerate(specs)), mesh)
            cache = [layers[i] for i in range(len(specs))]
            tok = _placed({"token": ins["token"]}, SD.batch_pspecs(ins, mesh, layout), mesh)
            args = (p, layers, tok)
            # the position (a Python int here) feeds RoPE and the mask: with
            # attention it is an argument of 4 bytes
            pos_bytes = 4 if cfg.n_heads else 0
            with implicit_replication(), StepCounter() as counter:
                out = model.decode_step(cfg, p, tok["token"], cell.seq_len - 1, cache)
        memory = MemoryAnalysis(
            argument_size_in_bytes=sum(_local_bytes(a, counter.read) for a in args) + pos_bytes,
            output_size_in_bytes=_local_bytes(_tree(out)),
            temp_size_in_bytes=int(counter.peak_bytes))
    return counter.stats, memory


def _extrapolated(runs, n_blocks: int, nm: int):
    """:class:`HloStats` and :class:`MemoryAnalysis` of ``n_blocks`` blocks in
    ``nm`` microbatches from ``runs[(b, k)]``, b in :data:`_BLOCKS` and k in
    :func:`_micro_counts` ``(nm)``.  Counts and argument and output bytes
    are bilinear in (blocks, microbatches); the peak is affine in blocks
    (the microbatches run one after another)."""
    b1, b2 = _BLOCKS
    ks = _micro_counts(nm)
    k1, k2 = ks[0], ks[-1]

    def at(f):
        v = {bk: f(*r) for bk, r in runs.items()}
        per_block = v[(b2, k1)] - v[(b1, k1)]
        out = v[(b1, k1)] + per_block * (n_blocks - b1)
        if k2 != k1:
            per_micro = v[(b1, k2)] - v[(b1, k1)]
            both = v[(b2, k2)] - v[(b1, k2)] - per_block
            out += per_micro * (nm - k1) + both * (n_blocks - b1) * (nm - k1)
        return out

    stats = HloStats(
        dot_flops=at(lambda st, _: st.dot_flops),
        traffic_bytes=at(lambda st, _: st.traffic_bytes),
        collective_bytes=at(lambda st, _: st.collective_bytes),
        per_collective={k: at(lambda st, _, k=k: st.per_collective[k]) for k in COLLECTIVES},
        largest_collective={k: max(st.largest_collective[k] for st, _ in runs.values())
                            for k in COLLECTIVES})
    memory = MemoryAnalysis(
        argument_size_in_bytes=int(at(lambda _, m: m.argument_size_in_bytes)),
        output_size_in_bytes=int(at(lambda _, m: m.output_size_in_bytes)),
        temp_size_in_bytes=int(runs[(b1, k1)][1].temp_size_in_bytes + (n_blocks - b1) * (
            runs[(b2, k1)][1].temp_size_in_bytes - runs[(b1, k1)][1].temp_size_in_bytes)))
    return stats, memory


# the block counts an extrapolated step is run at: past the first block,
# whose placements DTensor may still be settling (an SSD stack's does)
_BLOCKS = (2, 3)


def _micro_counts(nm: int):
    """The microbatch counts an extrapolated train step is run at: ``nm``
    itself up to 2, else 2 and 3 (one microbatch takes another code path)."""
    return (nm,) if nm <= 2 else (2, 3)


def lower_cell(arch: str, shape: str, mesh, opt_cfg: Optional[AdamWConfig] = None,
               policy_extra: Optional[dict] = None, layout: str = "fsdp_tp",
               cfg_overrides: Optional[dict] = None,
               n_micro_override: Optional[int] = None,
               global_batch: Optional[int] = None, extrapolate: bool = False) -> CellAccount:
    """Account for one step of the cell on ``mesh`` (a ``DeviceMesh`` over
    the current process group, fake or not).  ``global_batch`` cuts the
    cell's batch (the port's addition, for a cell that fits one card).

    ``extrapolate``: a decoder-only model's step is accounted at two and
    three blocks of layers (and two and three microbatches of the cell's
    size, where it has more) and extended to the config's blocks and
    microbatches (:func:`_extrapolated`), as the reference multiplies a
    scanned body by its trip count: every block past the first and every
    microbatch does the same work.  Without it the step runs whole."""
    t0 = time.perf_counter()
    mesh = _joint_fsdp(mesh)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SH.SHAPES[shape]
    gb = global_batch or cell.global_batch
    opt_cfg = opt_cfg or AdamWConfig()
    nm = _fit_n_micro(n_micro_override or SH.n_micro(arch, shape), gb, mesh, layout)
    policy = {**_act_policy(mesh), **(policy_extra or {})}
    if layout == "dp_only":
        policy["dp"] = tuple(mesh.mesh_dim_names)
        policy["tp"] = None
        policy["moe_groups"] = 1
    run = functools.partial(_account, arch, shape, mesh=mesh, opt_cfg=opt_cfg,
                            policy=policy, layout=layout)
    whole = not extrapolate or cfg.is_encdec or (cfg.n_blocks <= _BLOCKS[1] and nm <= 3)
    if whole:
        stats, memory = run(cfg=cfg, gb=gb, nm=nm)
    else:
        per = len(cfg.block)
        runs = {(b, k): run(cfg=dataclasses.replace(cfg, n_layers=b * per + len(cfg.tail)),
                            gb=gb // nm * k, nm=k)
                for b in _BLOCKS for k in _micro_counts(nm)}
        stats, memory = _extrapolated(runs, cfg.n_blocks, nm)
    return CellAccount(arch, shape, nm, stats, memory, time.perf_counter() - t0,
                       extrapolated=not whole)


def _tree(out):
    """A step's result as a tree :func:`flatten_tree` walks."""
    if isinstance(out, (tuple, list)) and not hasattr(out, "_fields"):
        return {str(i): _tree(v) for i, v in enumerate(out)}
    return out


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape: str, mesh, mesh_name: str) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name}
    skip = SH.cell_skip_reason(arch, shape)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        return rec
    t0 = time.time()
    try:
        acct = lower_cell(arch, shape, mesh, extrapolate=True)
        rec["status"] = "ok"
        rec["compile_s"] = round(time.time() - t0, 1)
        rec["extrapolated"] = acct.extrapolated
        rec["memory"] = dataclasses.asdict(acct.memory_analysis())
        rec["cost"] = {"flops": float(acct.stats.dot_flops),
                       "bytes_accessed": float(acct.stats.traffic_bytes)}
        rec["collectives"] = collective_bytes(acct.stats)
        rec["hlo"] = acct.stats.as_dict()
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def run_dryrun(archs=None, shapes=None, meshes=("single", "multi"),
               out_path: Optional[str] = None, device_type: str = "cuda") -> Dict[str, Any]:
    archs = archs or SH._ARCH_ORDER
    shapes = shapes or list(SH.SHAPES)
    results = []
    for mesh_name in meshes:
        with fake_production_mesh(mesh_name, device_type) as mesh:
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mesh, mesh_name)
                    status = rec["status"]
                    extra = (f" {rec.get('compile_s', '')}s" if status == "ok"
                             else f" ({rec.get('reason', rec.get('error', ''))[:80]})")
                    print(f"[{mesh_name:6s}] {arch:24s} {shape:12s} {status}{extra}",
                          flush=True)
                    results.append(rec)
    summary = {
        "results": results,
        "ok": sum(r["status"] == "ok" for r in results),
        "skip": sum(r["status"] == "skip" for r in results),
        "fail": sum(r["status"] == "fail" for r in results),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run (accounting on fake tensors)")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="reports/dryrun.json")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="the fake mesh's device type (cuda needs a card)")
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    summary = run_dryrun(args.arch, args.shape, meshes, args.out, args.device_type)
    print(f"\nok={summary['ok']} skip={summary['skip']} fail={summary['fail']}")
    if summary["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
