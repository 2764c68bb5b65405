"""The port's dry-run accounting (``launch/{hloanal,dryrun,perf}.py``) and
the ``--mesh`` launchers, against ``repro`` where both answer.

* ``_fit_n_micro`` and ``_act_policy`` equal ``repro``'s on the single
  (16, 16) and multi (2, 16, 16) meshes (``repro``'s on an ``AbstractMesh``,
  the port's on the same ``{axis: size}``), for every requested count,
  global batch and layout below; ``run_cell``'s skip records equal
  ``repro``'s ``cell_skip_reason`` for all 40 (arch, shape) pairs.
* Hand-counted steps on a fake process group of 4 ranks, exact: a
  ``Shard(0)`` weight gathered over 4 ranks is an all-gather of the
  weight's bytes; a row-parallel product all-reduces the output's bytes
  and does a quarter of the FLOPs per rank; ``a @ b + c`` moves its
  operands' and results' bytes; a collective per mesh axis is found by its
  group.
* ``perf.VARIANTS`` has the reference's six names; on the olmo smoke's
  train cell (seq 64, batch 8) on a (2, 2) mesh ``lowmem``'s temp is below
  ``base``'s and ``dponly`` moves fewer bytes over the model axis than
  ``base``.
* ``python -m repro_torch.launch.train --arch olmo-1b --mesh single --device
  cpu`` and ``serve ... --mesh multi --device cpu`` exit 0 with an ``ok``
  record of the full config, each under its own deadline.

The smoke cells against ``repro``'s compiled cells are in
``test_torch_dryrun_parity.py``.
"""
import ast
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import shapes as RS
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import perf as PF
from repro_torch.launch import shapes as TS
from repro_torch.launch.hloanal import COLLECTIVES, StepCounter, analyze_step


@contextlib.contextmanager
def _no_xla_flags_change():
    """``repro.launch.{dryrun,perf}`` set ``XLA_FLAGS`` when imported: keep
    this process's JAX as it was."""
    before = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


with _no_xla_flags_change():
    from repro.launch import dryrun as RD
    from repro.launch import perf as RP

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def _abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape),
                        axis_types=(AxisType.Auto,) * len(shape))


@contextlib.contextmanager
def fake_world(n):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ===========================================================================
# Policy, microbatches, skips
# ===========================================================================
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_act_policy_matches_reference(mesh):
    assert DR._act_policy(MESHES[mesh]) == RD._act_policy(_abstract(MESHES[mesh]))


@pytest.mark.parametrize("layout", ["fsdp_tp", "dp_only"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_n_micro_matches_reference(mesh, layout):
    ref_mesh = _abstract(MESHES[mesh])
    for requested in range(1, 19):
        for batch in (1, 2, 8, 16, 32, 48, 128, 256, 512):
            assert DR._fit_n_micro(requested, batch, MESHES[mesh], layout) == \
                RD._fit_n_micro(requested, batch, ref_mesh, layout), (requested, batch)


def test_skip_records_match_reference():
    pairs = list(TS.all_cells())
    assert pairs == list(RS.all_cells()) and len(pairs) == 40
    for arch, shape in pairs:
        want = RS.cell_skip_reason(arch, shape)
        assert TS.cell_skip_reason(arch, shape) == want
        if want:      # a skipped cell returns before any accounting
            rec = DR.run_cell(arch, shape, None, "single")
            assert rec == {"arch": arch, "shape": shape, "mesh": "single",
                           "status": "skip", "reason": want}
    assert sum(bool(RS.cell_skip_reason(a, s)) for a, s in pairs) == 6


# ===========================================================================
# Hand-counted steps
# ===========================================================================
def test_gathered_weight_is_an_all_gather_of_its_bytes():
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("d",))
        w = distribute_tensor(torch.empty(128, 64, device="meta"), mesh, [Shard(0)],
                              src_data_rank=None)
        stats = analyze_step(w.full_tensor)
    assert stats.per_collective == {**dict.fromkeys(COLLECTIVES, 0.0),
                                    "all-gather": 128 * 64 * 4}
    assert stats.collective_bytes == 128 * 64 * 4 and stats.dot_flops == 0


def test_row_parallel_product_all_reduces_its_output():
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("d",))
        a = distribute_tensor(torch.empty(16, 128, device="meta"), mesh, [Shard(1)],
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(128, 32, device="meta"), mesh, [Shard(0)],
                              src_data_rank=None)
        stats = analyze_step(lambda: (a @ b).redistribute(mesh, [Replicate()]))
    assert stats.per_collective["all-reduce"] == 16 * 32 * 4
    assert stats.collective_bytes == 16 * 32 * 4
    assert stats.dot_flops == 2 * 16 * 32 * 128 // 4       # each rank's quarter
    assert stats.n_while == 0 and stats.trip_counts == []


def test_traffic_is_operand_and_result_bytes():
    a, b, c = (torch.empty(s, device="meta") for s in ((8, 16), (16, 4), (8, 4)))
    with StepCounter() as counter:
        out = a @ b + c
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4          # a, b in; a @ b out
    add = 3 * 8 * 4 * 4                          # a @ b, c in; the sum out
    assert counter.stats.traffic_bytes == mm + add
    assert counter.stats.dot_flops == 2 * 8 * 4 * 16
    assert counter.peak_bytes == 2 * 8 * 4 * 4   # a @ b and the sum, at once
    views = StepCounter()
    with views:
        out.reshape(4, 8).t()[:3].detach()       # views only: no copy
    assert views.stats.traffic_bytes == 0 and views.peak_bytes == 0


def test_collectives_are_found_by_mesh_axis():
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(8, 6, device="meta"), mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        with StepCounter() as counter:
            x.redistribute(mesh, [Shard(0), Replicate()])
        model = mesh.get_group("model").group_name
    assert counter.by_group == {("all-gather", model): 4 * 6 * 4}


# ===========================================================================
# perf.py's variants
# ===========================================================================
def test_variant_names_match_reference():
    assert list(PF.VARIANTS) == list(RP.VARIANTS)
    opt, pol = PF.VARIANTS["lowmem"]
    assert opt.accum_dtype == torch.bfloat16 and pol is None
    assert PF.VARIANTS["compress"][0].grad_compress_bits == 8
    assert PF.VARIANTS["sp"][1] == {"sp": "model"}
    assert PF.VARIANTS["dponly"][1] == "dp_only"
    assert PF.VARIANTS["rematdots"][1] == {"__cfg__": {"remat_policy": "dots"}}


@pytest.fixture
def smoke_cells(monkeypatch):
    """The smoke configs, and train_4k cut to seq 64 x batch 8."""
    monkeypatch.setattr(DR, "get_config", get_smoke_config)
    monkeypatch.setattr(TS, "get_config", get_smoke_config)
    monkeypatch.setitem(TS.SHAPES, "train_4k", TS.ShapeCell("train_4k", 64, 8, "train"))


def test_lowmem_and_dponly_on_the_smoke_train_cell(smoke_cells):
    torch.set_num_threads(1)
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        model = mesh.get_group("model").group_name
        seen = {}

        class Keep(StepCounter):
            def __exit__(self, *exc):
                seen["by_group"] = dict(self.by_group)
                return super().__exit__(*exc)

        recs = {}
        for name in ("base", "lowmem", "dponly"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(DR, "StepCounter", Keep)
                recs[name] = PF.run_variant("olmo-1b", "train_4k", mesh, name)
            recs[name]["model_axis_bytes"] = sum(
                b for (_, g), b in seen["by_group"].items() if g == model)
            recs[name]["model_axis_all_reduce"] = seen["by_group"].get(("all-reduce", model), 0)
    base, lowmem, dponly = recs["base"], recs["lowmem"], recs["dponly"]
    assert lowmem["memory"]["temp_size_in_bytes"] < base["memory"]["temp_size_in_bytes"]
    assert lowmem["memory"]["argument_size_in_bytes"] < base["memory"]["argument_size_in_bytes"]
    # dp_only has no tensor parallelism: only the FSDP gathers and
    # reductions of the parameters split over "model" cross that axis, and
    # the loss's float32 scalars; base all-reduces activations over it
    assert dponly["model_axis_bytes"] > 0
    assert dponly["model_axis_all_reduce"] <= 3 * 4 < base["model_axis_all_reduce"]
    for r in recs.values():
        assert r["hlo"]["dot_flops"] == base["hlo"]["dot_flops"]


# ===========================================================================
# Extrapolation over blocks and microbatches
# ===========================================================================
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-235b-a22b", "mamba2-370m"])
def test_extrapolated_cells_equal_whole_steps(monkeypatch, arch):
    """Six blocks in four microbatches (train) and six blocks (prefill,
    decode), accounted whole and from two and three blocks: FLOPs,
    collectives, argument and output bytes equal; traffic too but for the
    SSD stack, whose backward placements settle only after a few blocks
    (within 10%); the peak, the largest of pieces each affine in the
    blocks, within 10% (25% for the SSD stack)."""
    import dataclasses

    def deep(name):
        c = get_smoke_config(name)
        return dataclasses.replace(c, n_layers=len(c.block) * 6 + len(c.tail))

    monkeypatch.setattr(DR, "get_config", deep)
    monkeypatch.setattr(TS, "get_config", deep)
    cells = {"train_4k": (64, 16, "train"), "prefill_32k": (64, 4, "prefill"),
             "decode_32k": (64, 8, "decode")}
    for name, (s, b, k) in cells.items():
        monkeypatch.setitem(TS.SHAPES, name, TS.ShapeCell(name, s, b, k))
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        for shape in cells:
            nm = 4 if shape == "train_4k" else None
            whole = DR.lower_cell(arch, shape, mesh, n_micro_override=nm)
            ex = DR.lower_cell(arch, shape, mesh, n_micro_override=nm, extrapolate=True)
            assert ex.extrapolated and not whole.extrapolated
            assert ex.stats.dot_flops == whole.stats.dot_flops, shape
            assert ex.stats.per_collective == whole.stats.per_collective, shape
            mw, me = whole.memory_analysis(), ex.memory_analysis()
            assert me.argument_size_in_bytes == mw.argument_size_in_bytes
            assert me.output_size_in_bytes == mw.output_size_in_bytes
            ssd = arch == "mamba2-370m"
            assert ex.stats.traffic_bytes == pytest.approx(whole.stats.traffic_bytes,
                                                           rel=0.1 if ssd else 0)
            assert me.temp_size_in_bytes == pytest.approx(mw.temp_size_in_bytes,
                                                          rel=0.25 if ssd else 0.1)


# ===========================================================================
# The launchers' --mesh
# ===========================================================================
def _launch(module, *args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ast.literal_eval(proc.stdout.strip().splitlines()[-1])


def test_train_launcher_mesh_single():
    rec = _launch("repro_torch.launch.train", "--arch", "olmo-1b", "--mesh", "single",
                  "--device", "cpu", timeout=300)
    assert rec["status"] == "ok" and rec["shape"] == "train_4k" and rec["mesh"] == "single"
    assert "trace" not in rec and rec["hlo"]["dot_flops"] == rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0


def test_serve_launcher_mesh_multi():
    rec = _launch("repro_torch.launch.serve", "--arch", "olmo-1b", "--mesh", "multi",
                  "--dry-run", "--device", "cpu", timeout=300)
    assert rec["status"] == "ok" and rec["shape"] == "decode_32k" and rec["mesh"] == "multi"
    assert set(rec["collectives"]) == set(COLLECTIVES)
