"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

A fresh interpreter imports every ``repro_torch`` module and
``chip_smoke.py``'s imports, then must hold neither ``jax`` nor ``repro`` /
``repro.*`` in ``sys.modules`` (a bare prefix test would be wrong:
``repro_torch`` starts with ``repro``), nor ``msgpack`` or ``ml_dtypes``,
which the reference's checkpoints use and the card's machine lacks.  Without a CUDA device, the default
device raises and ``chip_smoke.py`` exits non-zero without printing a
result.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
FORBIDDEN = ("jax", "repro", "msgpack", "ml_dtypes")
bad = sorted(n for n in sys.modules
             if n in FORBIDDEN or n.startswith(tuple(f + "." for f in FORBIDDEN)))
print("BAD", bad)
print("MODULES", sorted(n for n in sys.modules if n.startswith("repro_torch")))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


_FIRST = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
bad = []
for name in names:
    for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[k]
    try:
        importlib.import_module(name)
    except ImportError as e:
        bad.append(f"{name}: {e}")
print("BAD", bad)
"""


def test_every_module_imports_first():
    """Any module of the port can be the first one a program imports: no
    import cycle depends on the order (``dataprep.table`` needs
    ``core.device``, whose package must not import ``core.pipeline``,
    which imports the table back)."""
    out = subprocess.run([sys.executable, "-c", _FIRST], capture_output=True, text=True,
                         env=_env(), timeout=300, check=True)
    assert out.stdout.strip() == "BAD []", out.stdout


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), timeout=300, check=True)
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["BAD"] == "[]", out.stdout
    for mod in ("repro_torch.kernels.batched_walk", "repro_torch.core.carry",
                "repro_torch.provenance.session", "repro_torch.dataprep.usecases",
                "repro_torch.provenance.catalog", "repro_torch.provenance.federation",
                "repro_torch.provenance.impact", "repro_torch.train.checkpoint",
                "repro_torch.train.loop", "repro_torch.data.pipeline",
                "repro_torch.launch.train", "repro_torch.launch.shapes",
                "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                "repro_torch.models.pshard", "repro_torch.core.distributed",
                "repro_torch.launch.dryrun", "repro_torch.launch.hloanal",
                "repro_torch.launch.perf", "repro_torch.models.tp"):
        assert repr(mod) in lines["MODULES"]


def test_no_import_statement_names_jax_or_the_reference():
    """Also the imports inside functions, which the subprocess never runs
    (``chip_smoke.main`` imports the port lazily); ``msgpack`` and
    ``ml_dtypes`` neither."""
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             *sorted((ROOT / "examples" / "torch").glob("*.py")),
             *sorted((ROOT / "tools").glob("*.py"))]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "repro", "msgpack", "ml_dtypes"), \
                    f"{path.name} imports {name}"


_HIGHER = tuple(f"repro_torch.{p}" for p in (
    "provenance", "serve", "launch", "train", "models", "data", "configs"))
# the index's two accessors of the query layer, imported at call time
_UPWARD_ALLOWED = {("core/pipeline.py", "session"), ("core/pipeline.py", "export")}


def _imports_by_function(tree):
    """``(enclosing function name or None, imported module)`` of every
    import statement, module scope and function bodies alike."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                out.extend((fn, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                base = child.module or ""
                out.append((fn, base))
                # ``from repro_torch import provenance`` names the package too
                out.extend((fn, f"{base}.{a.name}") for a in child.names)
            visit(child, fn)

    visit(tree, None)
    return out


def test_lower_layers_import_no_higher_layer():
    """``core``, ``kernels`` and ``dataprep`` sit under the query, serving,
    training and launch layers, and import none of them, in functions too:
    the one exception is ``ProvenanceIndex.session()`` / ``export()``."""
    pkg = ROOT / "src" / "repro_torch"
    files = [p for sub in ("core", "kernels", "dataprep") for p in sorted((pkg / sub).rglob("*.py"))]
    assert files
    seen_allowed = set()
    for path in files:
        rel = path.relative_to(pkg).as_posix()
        for fn, name in _imports_by_function(ast.parse(path.read_text())):
            if not (name in _HIGHER or name.startswith(tuple(h + "." for h in _HIGHER))):
                continue
            assert (rel, fn) in _UPWARD_ALLOWED, f"{rel}:{fn or '<module>'} imports {name}"
            seen_allowed.add((rel, fn))
    # the allow-list names no accessor that has stopped importing upward
    assert seen_allowed == _UPWARD_ALLOWED


def test_default_device_is_cuda_or_raises():
    import torch.distributed as dist

    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.table import Table
    from repro_torch.launch.dryrun import fake_production_mesh, run_dryrun
    from repro_torch.provenance import ProvCatalog

    if torch.cuda.is_available():
        assert ProvenanceIndex().device.type == "cuda"
        assert ProvCatalog().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProvenanceIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProvCatalog()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Table.from_columns({"a": np.zeros(2, np.float32)})
    # the dry run's fake meshes are the card's unless the CPU is named
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_dryrun(["olmo-1b"], ["train_4k"], ("single",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with fake_production_mesh("multi"):
            pass
    assert not dist.is_initialized()
    assert ProvenanceIndex(device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    run = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
