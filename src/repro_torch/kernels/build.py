"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface (no PyTorch headers, so ``nvcc`` takes seconds), built
for ``sm_90a`` into ``build/repro_torch/`` at the root of the checkout.
The file name carries a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is.  All sources are
compiled in parallel, one ``nvcc`` process each.  A failed or missing
``nvcc`` raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME or "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.
    Returns {kernel source stem: library path}."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = {src.stem: _lib_path(src) for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for src in todo:
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[src.stem])
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LOADED:
        libs = build_all()
        if name not in libs:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        _LOADED[name] = ctypes.CDLL(str(libs[name]))
    return _LOADED[name]
