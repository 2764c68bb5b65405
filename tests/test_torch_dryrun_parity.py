"""The port's dry-run accounting of smoke cells against ``repro``'s compiled
cells.

Six smoke configs (olmo-1b, gemma3-1b, mamba2-370m, qwen3-moe-235b-a22b,
whisper-small, llama3-405b: dense, local/global attention with one K/V
head, SSD, MoE, encoder-decoder, ``n_micro`` 4), each with a train (seq
64, global batch 8), a prefill (64 x 4) and a decode cell (cache 64, batch
8).  ``repro``'s side is ``lower_cell`` + ``compile`` in a subprocess with
4 host devices (``--xla_force_host_platform_device_count=4``, as
``test_torch_sharding.py`` does), the port's ``dryrun.lower_cell`` on a
fake process group in this process.

* On a (2, 2) ("data", "model") mesh, per-device argument bytes equal
  ``compiled.memory_analysis().argument_size_in_bytes`` exactly (inputs a
  step never reads are no arguments on either side).
* On both meshes, dot FLOPs are within 5% of ``analyze_hlo``'s; every gap
  is printed (``-s``).  On the (2, 2) mesh the four ranks together also do
  at least the one-device work.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as TS
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "gemma3-1b", "mamba2-370m", "qwen3-moe-235b-a22b", "whisper-small",
         "llama3-405b"]
CELLS = {"train_4k": (64, 8, "train"), "prefill_32k": (64, 4, "prefill"),
         "decode_32k": (64, 8, "decode")}
PAIRS = [(a, s) for a in ARCHS for s in CELLS]
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
FLOPS_REL = 0.05

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro.configs.registry import get_smoke_config
import repro.launch.dryrun as DR, repro.launch.shapes as SH
from repro.launch.hloanal import analyze_hlo
from repro.launch.mesh import make_mesh_compat
DR.get_config = get_smoke_config
SH.get_config = get_smoke_config
cells, pairs, meshes = (json.loads(a) for a in sys.argv[1:4])
SH.SHAPES = {n: SH.ShapeCell(n, s, b, k) for n, (s, b, k) in cells.items()}
out = {}
for name, shape in meshes.items():
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    for arch, cell in pairs:
        _, compiled = DR.lower_cell(arch, cell, mesh)
        out[f"{name}/{arch}/{cell}"] = {
            "argument": int(compiled.memory_analysis().argument_size_in_bytes),
            "dot_flops": analyze_hlo(compiled.as_text()).dot_flops}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def accounts():
    """``{mesh/arch/cell: (port, reference)}`` with the port's
    ``CellAccount`` and the reference's argument bytes and dot FLOPs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, json.dumps(CELLS),
                            json.dumps(PAIRS), json.dumps(MESHES)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DR, "get_config", get_smoke_config)
        mp.setattr(TS, "get_config", get_smoke_config)
        for name, (s, b, k) in CELLS.items():
            mp.setitem(TS.SHAPES, name, TS.ShapeCell(name, s, b, k))
        for name, shape in MESHES.items():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=shape[0] * shape[1])
            try:
                mesh = make_mesh(shape, ("data", "model"), "cpu")
                for arch, cell in PAIRS:
                    port[f"{name}/{arch}/{cell}"] = DR.lower_cell(arch, cell, mesh)
            finally:
                dist.destroy_process_group()
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    return {k: (port[k], want[k]) for k in port}


def _gap(port, want) -> float:
    gap = port.stats.dot_flops / want["dot_flops"] - 1
    print(f"{port.arch:22s} {port.shape:12s} dot FLOPs {port.stats.dot_flops:.6g} vs "
          f"{want['dot_flops']:.6g}: {gap:+.4f}")
    return gap


@pytest.mark.parametrize("arch,cell", PAIRS)
def test_argument_bytes_equal_reference(accounts, arch, cell):
    port, want = accounts[f"2x2/{arch}/{cell}"]
    assert port.memory_analysis().argument_size_in_bytes == want["argument"]


@pytest.mark.parametrize("arch,cell", PAIRS)
def test_dot_flops_on_one_device(accounts, arch, cell):
    port, want = accounts[f"1x1/{arch}/{cell}"]
    assert port.memory_analysis().argument_size_in_bytes == want["argument"]
    assert abs(_gap(port, want)) <= FLOPS_REL


@pytest.mark.parametrize("arch,cell", PAIRS)
def test_dot_flops_on_2x2(accounts, arch, cell):
    assert abs(_gap(*accounts[f"2x2/{arch}/{cell}"])) <= FLOPS_REL


@pytest.mark.parametrize("arch,cell", PAIRS)
def test_four_ranks_do_the_one_device_work(accounts, arch, cell):
    sharded, want2 = accounts[f"2x2/{arch}/{cell}"]
    _gap(sharded, want2)
    one = accounts[f"1x1/{arch}/{cell}"][0]
    assert 4 * sharded.stats.dot_flops >= (1 - FLOPS_REL) * one.stats.dot_flops
    assert sharded.stats.n_while == 0 and sharded.stats.trip_counts == []
