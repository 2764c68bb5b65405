"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

A fresh interpreter imports every ``repro_torch`` module and
``chip_smoke.py``'s imports, then must hold neither ``jax`` nor ``repro`` /
``repro.*`` in ``sys.modules`` (a bare prefix test would be wrong:
``repro_torch`` starts with ``repro``).  Without a CUDA device, the default
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
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
print("BAD", bad)
print("MODULES", sorted(n for n in sys.modules if n.startswith("repro_torch")))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), timeout=300, check=True)
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["BAD"] == "[]", out.stdout
    for mod in ("repro_torch.kernels.batched_walk", "repro_torch.core.carry",
                "repro_torch.provenance.session", "repro_torch.dataprep.usecases"):
        assert repr(mod) in lines["MODULES"]


def test_no_import_statement_names_jax_or_the_reference():
    """Also the imports inside functions, which the subprocess never runs
    (``chip_smoke.main`` imports the port lazily)."""
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
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
                assert top not in ("jax", "repro"), f"{path.name} imports {name}"


def test_default_device_is_cuda_or_raises():
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.table import Table

    if torch.cuda.is_available():
        assert ProvenanceIndex().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProvenanceIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Table.from_columns({"a": np.zeros(2, np.float32)})
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
