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

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "launcher",
           "check_launch", "check_card", "check_operands"]

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


def launcher(name: str, argtypes: list):
    """``<name>_launch`` of ``csrc/<name>.cu`` with its ctypes signature set:
    ``argtypes`` (``c_void_p`` for pointers and the stream, ``c_int`` for
    ints), returning the ``cudaError_t`` code as an int."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise unless the launch returned ``cudaSuccess``."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def check_card(name: str, dev: torch.device) -> torch.device:
    """``dev``, after checking that it is a CUDA card of compute capability
    (9, 0)."""
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel runs on a CUDA card; its operands lie on {dev}")
    if torch.cuda.get_device_capability(dev) < (9, 0):
        raise RuntimeError(
            f"{name} kernel is built for sm_90a; {torch.cuda.get_device_name(dev)} "
            f"has capability {torch.cuda.get_device_capability(dev)}")
    return dev


def check_operands(name: str, tensors, ndims) -> torch.device:
    """The one CUDA device of ``tensors``, after checking that it has
    compute capability (9, 0) and that every tensor lies on it, is int32,
    contiguous and of the dimension given in ``ndims``."""
    dev = check_card(name, tensors[0].device)
    for t, nd in zip(tensors, ndims):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
            raise ValueError(
                f"{name} kernel takes contiguous {nd}-D int32 tensors on one device; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return dev
