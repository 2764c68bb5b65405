"""The port's partition rules and shape cells against ``repro``'s.

* For all ten configs, every parameter leaf's spec equals ``repro``'s at
  (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data", "model"): the
  reference's specs come from ``SD.param_pspecs`` over ``jax.eval_shape``
  on an ``AbstractMesh`` (no devices), the port's from the same rule over
  its per-layer parameters on the meta device, paired with the reference's
  leaves by ``carry.reference_path`` (a stacked leaf's spec is the port's
  with the reference's leading ``None``).  The same for the decode caches
  (``decode_32k`` and ``long_500k`` where they run), the batch specs of
  all 40 cells, and ``state_pspecs``.
* Twins of ``test_whisper_vocab_falls_back_to_replicated`` and
  ``test_batch_specs``; ``launch.shapes`` field by field (the 40 cells,
  skips, ``n_micro``, ``q_chunk``, input and cache shapes and dtypes, the
  port's on the meta device).
* Placements: under a gloo job of 4 CPU ranks (``torch_spawn``, one job,
  120 s deadline) each rank's local shard of a tensor placed by
  ``to_placements`` is the slice that ``NamedSharding.devices_indices_map``
  gives its device, computed in a JAX subprocess with 4 host devices; one
  case shards one dim over two axes ("pod", "data"), which DTensor splits
  pod-major as JAX does.
* ``launch.mesh``'s production meshes, (16, 16) and (2, 16, 16), and the
  shard mesh on a fake process group of 256 and 512 ranks in this
  process; without a process group no mesh is built.

Tolerance 0: specs, shapes and shard contents are compared exactly.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.configs.registry import ARCHS, get_config as r_get_config
from repro.launch import shapes as RS
from repro.launch import sharding as RSD
from repro.models.registry import get_model as r_get_model
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.trainer import init_train_state as r_init_state
from repro_torch.configs.registry import get_config
from repro_torch.launch import shapes as TS
from repro_torch.launch import sharding as SD
from repro_torch.models.carry import reference_path
from repro_torch.models.lm import LM
from repro_torch.models.whisper import Whisper
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import init_train_state
from torch_mesh_jobs import PLACEMENT_CASES, PLACEMENT_X
from torch_spawn import run_jobs

ROOT = Path(__file__).resolve().parents[1]
R_MESH = {
    "1pod": AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2),
    "2pod": AbstractMesh((2, 16, 16), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3),
}
T_MESH = {"1pod": {"data": 16, "model": 16}, "2pod": {"pod": 2, "data": 16, "model": 16}}


def _entries(spec, rank):
    """A reference PartitionSpec as the port's tuple, one entry per dim."""
    out = tuple(spec) + (None,) * (rank - len(spec))
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def _ref_leaves(tree):
    """{path: leaf} of a reference tree of specs or shapes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {RSD._path_str(p): leaf for p, leaf in flat}


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = r_get_config(arch)
    return jax.eval_shape(functools.partial(r_get_model(cfg).init_params, cfg),
                          jax.random.PRNGKey(0))


def _port_params(arch):
    cfg = get_config(arch)
    return cfg, (Whisper if cfg.is_encdec else LM)(cfg, device="meta")


def _check_params(cfg, port_specs, port_shapes, ref_specs, ref_shapes):
    ref_specs, ref_shapes = _ref_leaves(ref_specs), _ref_leaves(ref_shapes)
    seen = set()
    for name, spec in port_specs.items():
        path, j = reference_path(cfg, name)
        key = "/".join(path)
        seen.add(key)
        rshape = tuple(ref_shapes[key].shape)
        want = _entries(ref_specs[key], len(rshape))
        if j is not None:                 # a stacked reference leaf
            assert want[0] is None and rshape[1:] == port_shapes[name], name
            want = want[1:]
        else:
            assert rshape == port_shapes[name], name
        assert spec == want, (name, spec, want)
    assert seen == set(ref_specs)


@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_reference(arch, mesh):
    cfg, params = _port_params(arch)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    specs = SD.param_pspecs(cfg, params, T_MESH[mesh])
    ref_shapes = _ref_param_shapes(arch)
    _check_params(cfg, specs, shapes, RSD.param_pspecs(ref_shapes, R_MESH[mesh]), ref_shapes)
    for name, spec in specs.items():      # and every sharded dim divides
        for dim, entry in enumerate(spec):
            assert shapes[name][dim] % SD._axes_size(T_MESH[mesh], entry) == 0


def _ref_cache_key(cfg, layer: int, leaf: str):
    """(reference cache path, stacked?) of the port's cache leaf."""
    if cfg.is_encdec:
        return leaf, True
    path, j = reference_path(cfg, f"layers.{layer}.{leaf}")
    return "/".join(path), j is not None


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_equal_reference(arch):
    cfg = get_config(arch)
    ran = 0
    for shape in ("decode_32k", "long_500k"):
        assert TS.cell_skip_reason(arch, shape) == RS.cell_skip_reason(arch, shape)
        if TS.cell_skip_reason(arch, shape):
            continue
        ran += 1
        cache = TS.cache_specs(arch, shape)
        ref_shapes = _ref_leaves(RS.cache_specs(arch, shape))
        assert sum(len(lc) for lc in cache) == sum(
            v.shape[0] if (cfg.is_encdec or k.startswith("blocks/")) else 1
            for k, v in ref_shapes.items())
        for mesh in ("1pod", "2pod"):
            specs = SD.cache_pspecs(cache, T_MESH[mesh])
            ref_specs = _ref_leaves(RSD.cache_pspecs(RS.cache_specs(arch, shape), R_MESH[mesh]))
            for layer, (lc, ls) in enumerate(zip(cache, specs)):
                for leaf, t in lc.items():
                    key, stacked = _ref_cache_key(cfg, layer, leaf)
                    rshape = tuple(ref_shapes[key].shape)
                    want = _entries(ref_specs[key], len(rshape))
                    assert t.device.type == "meta" and t.dtype == torch.bfloat16 \
                        if leaf != "state" else t.dtype == torch.float32
                    if stacked:
                        assert want[0] is None and rshape[1:] == tuple(t.shape)
                        want = want[1:]
                    else:
                        assert rshape == tuple(t.shape)
                    assert ls[leaf] == want, (arch, shape, mesh, layer, leaf)
    assert ran >= 1


@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
def test_batch_specs_equal_reference_for_every_cell(mesh):
    for arch, shape in TS.all_cells():
        ins, r_ins = TS.input_specs(arch, shape), RS.input_specs(arch, shape)
        got = SD.batch_pspecs(ins, T_MESH[mesh])
        want = RSD.batch_pspecs(r_ins, R_MESH[mesh])
        assert set(got) == set(want)      # a jax tree sorts its keys
        for k in got:
            assert got[k] == _entries(want[k], len(r_ins[k].shape)), (arch, shape, k)
        assert SD.batch_pspecs(ins, T_MESH[mesh], "dp_only") == {
            k: _entries(v, len(r_ins[k].shape))
            for k, v in RSD.batch_pspecs(r_ins, R_MESH[mesh], "dp_only").items()}


def test_batch_specs():
    """Twin of ``tests/test_sharding.py::test_batch_specs``."""
    specs = SD.batch_pspecs(TS.input_specs("llama3-405b", "train_4k"), T_MESH["2pod"])
    assert specs["tokens"][0] == ("pod", "data")
    specs1 = SD.batch_pspecs(TS.input_specs("mamba2-370m", "long_500k"), T_MESH["1pod"])
    assert specs1["token"][0] is None           # batch 1: replicated


def test_whisper_vocab_falls_back_to_replicated():
    """Twin of the reference's: 51865 is not 16-divisible, so the vocab dim
    is replicated while the d_model dim still FSDPs."""
    cfg = get_config("whisper-small")
    assert cfg.padded_vocab == 51_968
    spec = SD._param_rule(T_MESH["1pod"], "embed", (cfg.vocab, cfg.d_model))
    assert spec[0] is None and spec[1] is not None
    assert spec == _entries(RSD._param_rule(R_MESH["1pod"], "embed", (cfg.vocab, cfg.d_model)),
                            2)


@pytest.mark.parametrize("layout", ["fsdp_tp", "dp_only"])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-235b-a22b"])
def test_state_specs_equal_reference(arch, layout):
    r_cfg, cfg = r_get_config(arch), get_config(arch)
    r_shapes = jax.eval_shape(functools.partial(r_init_state, r_cfg, opt_cfg=RAdamW()),
                              jax.random.PRNGKey(0))
    r_specs = RSD.state_pspecs(r_shapes, R_MESH["1pod"], layout)
    state = init_train_state(cfg, torch.Generator(), AdamWConfig(), "meta")
    specs = SD.state_pspecs(cfg, state, T_MESH["1pod"], layout)
    shapes = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
    for part, r_part, r_shape in ((specs.params, r_specs.params, r_shapes.params),
                                  (specs.opt.mu, r_specs.opt.mu, r_shapes.opt.mu),
                                  (specs.opt.nu, r_specs.opt.nu, r_shapes.opt.nu)):
        _check_params(cfg, part, shapes, r_part, r_shape)
    assert specs.opt.step == tuple(r_specs.opt.step) == ()
    assert specs.opt.err is None and r_specs.opt.err is None


# ===========================================================================
# launch.shapes
# ===========================================================================
def test_shapes_equal_reference():
    assert list(TS.SHAPES) == list(RS.SHAPES)
    for k, cell in TS.SHAPES.items():
        r = RS.SHAPES[k]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == \
            (r.name, r.seq_len, r.global_batch, r.kind)
    cells = list(TS.all_cells())
    assert cells == list(RS.all_cells()) and len(cells) == 40
    for arch, shape in cells:
        assert TS.cell_skip_reason(arch, shape) == RS.cell_skip_reason(arch, shape)
        assert TS.n_micro(arch, shape) == RS.n_micro(arch, shape)
        assert TS.q_chunk(arch, shape) == RS.q_chunk(arch, shape)
        ins, r_ins = TS.input_specs(arch, shape), RS.input_specs(arch, shape)
        assert list(ins) == list(r_ins)
        for k, t in ins.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(r_ins[k].shape)
            assert str(t.dtype).removeprefix("torch.") == str(r_ins[k].dtype)


# ===========================================================================
# DTensor placements against NamedSharding.devices_indices_map
# ===========================================================================
_JAX_SLICES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases, shape = json.loads(sys.argv[1]), tuple(json.loads(sys.argv[2]))
out = []
for axes, spec in cases:
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), tuple(axes))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    out.append({str(d.id): [list(s.indices(n)[:2]) for s, n in zip(sl, shape)]
                for d, sl in m.items()})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def placement_job(tmp_path_factory):
    (res,) = run_jobs([("placement", 4, tmp_path_factory.mktemp("placement"), {})],
                      deadline=120)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SLICES, json.dumps(PLACEMENT_CASES),
                           json.dumps(PLACEMENT_X)], capture_output=True, text=True,
                          env=env, timeout=120, check=True)
    return res, json.loads(proc.stdout)


@pytest.mark.parametrize("case", range(len(PLACEMENT_CASES)))
def test_local_shards_are_named_sharding_slices(placement_job, case):
    ranks, slices = placement_job
    x = np.arange(int(np.prod(PLACEMENT_X)), dtype=np.float32).reshape(PLACEMENT_X)
    for rank, res in enumerate(ranks):        # rank r is device r: both row-major
        want = x[tuple(slice(a, b) for a, b in slices[case][str(rank)])]
        np.testing.assert_array_equal(res["locals"][case], want)


def test_to_placements_refuses_what_dtensor_cannot_split():
    mesh = type("Mesh", (), {"mesh_dim_names": ("pod", "data")})()
    with pytest.raises(ValueError, match="mesh order"):
        SD.to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="not all in mesh"):
        SD.to_placements(("model", None), mesh)
    with pytest.raises(ValueError, match="used twice"):
        SD.to_placements(("data", "data"), mesh)


# ===========================================================================
# launch.mesh on a fake world (no process is spawned, nothing communicates)
# ===========================================================================
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as M

    assert M.host_device_count() == 1 and M.make_shard_mesh(2) is None
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_local_mesh("cpu")
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert M.host_device_count() == world
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == want
        assert SD._shape(mesh) == want and SD.fsdp_axes(mesh) == tuple(
            a for a in ("pod", "data") if a in want)
        shards = M.make_shard_mesh(4, device_type="cpu")
        assert shards.mesh_dim_names == ("shards",) and shards.size() == 4
        assert M.make_shard_mesh(world + 1, device_type="cpu") is None
    finally:
        dist.destroy_process_group()
