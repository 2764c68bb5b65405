"""The port's dry-run accounting of the batch-1 long-context decode cells
against ``repro``'s compiled cells.

The four archs with a ``long_500k`` cell (gemma3-1b and gemma3-12b: local
and global attention, the smoke window of 8 against a 64-position cache;
mamba2-370m: SSD; jamba-1.5-large: SSD, attention and MoE), each cut to
its smoke config and the cell to seq 64, global batch 1.  ``repro``'s side
is ``lower_cell`` + ``compile`` in a subprocess with 4 host devices, as
``test_torch_dryrun_parity.py`` builds it; the port's is
``dryrun.lower_cell`` on a fake process group in this process.  The
cache's sequence is split over ("data", "model") jointly, the step's one
token over nothing: the port keeps the cache where it lies (a partial
softmax per rank, merged) and the residual stream's features over "data"
(each FSDP-split weight contracted where it lies), as GSPMD does.

* On (2, 2), per-device argument bytes equal the reference's exactly.
* Dot FLOPs within 5% on (1, 1) and (2, 2).
* Per-device collective result bytes on (2, 2) at most 1.05x the
  reference's ``collective_bytes`` (the reference's are float32 where its
  CPU backend widens bfloat16 collectives; the port's are the step's own
  dtypes).
* No all-gather's result is as large as one layer's K (or V) cache: no
  rank gathers the cache.
Every gap is printed (``-s``).
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
from repro_torch.models.registry import get_model

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma3-1b", "gemma3-12b", "mamba2-370m", "jamba-1.5-large-398b"]
CELL = ("long_500k", 64, 1)
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
FLOPS_REL = 0.05
COLLECTIVE_REL = 1.05

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
(name, seq, batch), archs, meshes = (json.loads(a) for a in sys.argv[1:4])
SH.SHAPES = {name: SH.ShapeCell(name, seq, batch, "decode")}
out = {}
for mname, shape in meshes.items():
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    for arch in archs:
        _, compiled = DR.lower_cell(arch, name, mesh)
        st = analyze_hlo(compiled.as_text())
        out[f"{mname}/{arch}"] = {
            "argument": int(compiled.memory_analysis().argument_size_in_bytes),
            "dot_flops": st.dot_flops, "collective_bytes": st.collective_bytes,
            "per_collective": st.per_collective}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def accounts():
    """``{mesh/arch: (port CellAccount, reference dict)}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, json.dumps(CELL),
                            json.dumps(ARCHS), json.dumps(MESHES)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    port = {}
    name, seq, batch = CELL
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DR, "get_config", get_smoke_config)
        mp.setattr(TS, "get_config", get_smoke_config)
        mp.setitem(TS.SHAPES, name, TS.ShapeCell(name, seq, batch, "decode"))
        for mname, shape in MESHES.items():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=shape[0] * shape[1])
            try:
                mesh = make_mesh(shape, ("data", "model"), "cpu")
                for arch in ARCHS:
                    port[f"{mname}/{arch}"] = DR.lower_cell(arch, name, mesh)
            finally:
                dist.destroy_process_group()
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    return {k: (port[k], want[k]) for k in port}


def _gap(what, got, want) -> float:
    gap = got / want - 1
    print(f"{what}: {got:.6g} vs {want:.6g}: {gap:+.4f}")
    return gap


@pytest.mark.parametrize("arch", ARCHS)
def test_long_argument_bytes_equal_reference(accounts, arch):
    port, want = accounts[f"2x2/{arch}"]
    assert port.memory_analysis().argument_size_in_bytes == want["argument"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_long_dot_flops_within_reference(accounts, arch, mesh):
    port, want = accounts[f"{mesh}/{arch}"]
    assert abs(_gap(f"{arch} {mesh} dot FLOPs", port.stats.dot_flops,
                    want["dot_flops"])) <= FLOPS_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_long_collective_bytes_within_reference(accounts, arch):
    port, want = accounts[f"2x2/{arch}"]
    print(f"{arch} 2x2 collectives by kind: {dict(port.stats.per_collective)} vs "
          f"{want['per_collective']}")
    _gap(f"{arch} 2x2 collective bytes", port.stats.collective_bytes, want["collective_bytes"])
    assert port.stats.collective_bytes <= COLLECTIVE_REL * want["collective_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_long_decode_gathers_no_cache(accounts, arch):
    port, _ = accounts[f"2x2/{arch}"]
    cfg = get_smoke_config(arch)
    cache = get_model(cfg).init_cache(cfg, CELL[2], CELL[1], device="meta")
    kv = [t.numel() * t.element_size() for lc in cache for n, t in lc.items() if n in ("k", "v")]
    largest = port.stats.largest_collective["all-gather"]
    print(f"{arch} 2x2 largest all-gather {largest:.0f} B, smallest K/V cache "
          f"{min(kv, default=0)} B")
    assert largest > 0
    if kv:
        assert largest < min(kv)
