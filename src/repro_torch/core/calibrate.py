"""Empirical calibration of the cost model on the card.

The routing constants in :mod:`repro_torch.core.costmodel` are ``repro``'s
host guesses; this module MEASURES them on the device the port runs on:

* a microbench grid over density x shape times the three composition
  primitives the router prices — the packed-bitplane compose
  (:func:`repro_torch.kernels.ops.bitmatmul`: the kernel on a card, its
  plain version on the CPU), the torch sparse CSR product, and the fused
  batched walk (:func:`repro_torch.kernels.ops.batched_walk`);
* on a card every time is taken with CUDA events after a synchronize (the
  host clock around an asynchronous launch would measure the enqueue), over
  enough back-to-back calls to fill a couple of milliseconds, and the
  card's grid reaches the sizes of the Compas and Census relations, so
  that each point's work exceeds a launch;
* medians per grid point feed linear least-squares fits
  ``time = overhead + slope x work`` giving ``c_word_op`` /
  ``c_spmm_flop`` / ``c_spmm_overhead`` / ``c_launch_overhead``, and the
  CSR-vs-bitplane crossover ``density_threshold =
  sqrt(c_word_op / (32 c_spmm_flop))``;
* the fitted :class:`~repro_torch.core.costmodel.Constants` persist to the
  JSON file the caller names, keyed by device name
  (``torch.cuda.get_device_name()``, ``"cpu"`` on the host);
  :func:`load_constants` reads one device's entry back.

Calibration installs nothing and nothing reads its file implicitly: the
router's constants change only where code passes a set to
:func:`repro_torch.core.costmodel.set_constants`.

Run directly::

    PYTHONPATH=src python -m repro_torch.core.calibrate --path FILE [--full]
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compose import compose_pair_csr, csr_from_pairs
from repro_torch.core.costmodel import Constants
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import wrap_int32

__all__ = [
    "device_kind",
    "run_microbench",
    "fit_constants",
    "save_constants",
    "load_constants",
    "calibrate",
]

_FILE_VERSION = 1


def device_kind(device=None) -> str:
    """Calibration-file key of ``device``: the card's name, ``"cpu"`` for
    the host.  ``None`` is the current CUDA device when there is one, else
    the host."""
    if device is None:
        return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


# ---------------------------------------------------------------------------
# Microbench harness
# ---------------------------------------------------------------------------
def _elapsed_ns(fn, calls: int, device: torch.device) -> float:
    """Wall time of ``calls`` back-to-back calls of ``fn``, in ns: between
    one pair of CUDA events on a card (issued after a synchronize), on the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e9
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e6


def _median_ns(fn, reps: int, device: torch.device) -> float:
    """Median over ``reps`` rounds of the mean time of one call of ``fn``,
    in ns.  Each round times as many back-to-back calls as fill about 2 ms
    (at least one, at most 100), so a short call is not read as the
    latency of one launch and its synchronize."""
    one = _elapsed_ns(fn, 1, device)                       # warm-up and estimate
    calls = int(min(max(2e6 // max(one, 1.0), 1), 100))
    return float(np.median([_elapsed_ns(fn, calls, device) / calls for _ in range(reps)]))


def _random_pairs(gen: torch.Generator, n: int, density: float, device):
    """Distinct (row, col) int64 links of a random n x n relation with about
    ``density * n * n`` links, drawn on ``device`` (no dense n x n array)."""
    m = int(round(density * n * n))
    lin = torch.unique(torch.randint(0, n * n, (m,), generator=gen, device=device))
    return lin // n, lin % n


def _pairs_bitplane(rows: torch.Tensor, cols: torch.Tensor, n: int) -> torch.Tensor:
    """Distinct links -> packed (n, ceil(n/32)) int32 bitplane; the links
    are distinct, so summing their bits into a word is their OR."""
    nw = (n + 31) // 32
    words = torch.zeros(n * nw, dtype=torch.int64, device=rows.device)
    words.index_add_(0, rows * nw + cols // 32, torch.ones_like(cols) << (cols % 32))
    return wrap_int32(words).reshape(n, nw)


# (n, density) grid points.  On the card the relations reach the sizes of
# the Compas (n ~ 7214) and Census (n = 32561) relations, so that the work
# of a point exceeds a launch by far; Census-sized points are sparser, which
# keeps the CSR product's output within a few hundred MB.  The CPU grid is
# small: the plain bitmatmul there is a dense float product.
_GRIDS = {
    ("cuda", True): [(n, d) for n in (1024, 4096, 7214) for d in (0.002, 0.01)]
    + [(32561, 0.0001), (32561, 0.0005)],
    ("cuda", False): [(n, d) for n in (1024, 2048, 4096, 7214) for d in (0.002, 0.005, 0.01, 0.02)]
    + [(32561, d) for d in (0.0001, 0.0002, 0.0005)],
    ("cpu", True): [(n, d) for n in (128, 256, 512) for d in (0.02, 0.1)],
    ("cpu", False): [(n, d) for n in (128, 256, 512, 1024, 2048)
                     for d in (0.005, 0.02, 0.08, 0.25)],
}


def run_microbench(quick: bool = True, seed: int = 0, device=None) -> Dict[str, object]:
    """Time bitmatmul / CSR product / fused walk over a density x shape grid
    on ``device`` (``None``: the card).  Returns raw grid rows (medians, ns)
    plus the device name — :func:`fit_constants` turns them into a
    :class:`Constants`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = 5 if quick else 9
    rows: List[Dict[str, object]] = []

    for n, d in _GRIDS[(dev.type, bool(quick))]:
        nw = (n + 31) // 32
        ra, ca = _random_pairs(gen, n, d, dev)
        rb, cb = _random_pairs(gen, n, d, dev)
        a, b = _pairs_bitplane(ra, ca, n), _pairs_bitplane(rb, cb, n)
        t = _median_ns(lambda: K.bitmatmul(a, b), reps, dev)
        rows.append({"kind": "bitmatmul", "n": n, "density": d,
                     "word_ops": n * n * nw, "t_ns": t})
        del a, b
        da, db = csr_from_pairs(ra, ca, n, n), csr_from_pairs(rb, cb, n, n)
        out_deg = db.values().shape[0] / max(n, 1)
        t = _median_ns(lambda: compose_pair_csr(da, db), reps, dev)
        rows.append({"kind": "spmm", "n": n, "density": d,
                     "flops": da.values().shape[0] * out_deg, "t_ns": t})
        del da, db

    # fused-walk dispatch: the smallest chain isolates per-launch overhead
    n, hops = 128, 4
    planes = [_pairs_bitplane(*_random_pairs(gen, n, 0.05, dev), n) for _ in range(hops)]
    mask = _pairs_bitplane(*_random_pairs(gen, n, 0.05, dev), n)[:8]
    t = _median_ns(lambda: K.batched_walk(mask, planes), reps, dev)
    rows.append({"kind": "fused_walk", "n": n, "hops": hops, "t_ns": t})
    return {"device": device_kind(dev), "rows": rows}


def _line_fit(xs: List[float], ys: List[float]) -> tuple:
    """(slope, intercept) least squares, both clamped non-negative."""
    if len(xs) < 2:
        return 0.0, float(ys[0]) if ys else 0.0
    slope, intercept = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return max(float(slope), 1e-6), max(float(intercept), 0.0)


def fit_constants(meas: Dict[str, object], base: Optional[Constants] = None) -> Constants:
    """Fit routing constants from :func:`run_microbench` output.

    Non-measured constants (walk dispatch, stitch, machine roofline terms)
    carry over from ``base`` (default: the uncalibrated defaults)."""
    base = base or Constants()
    rows = meas["rows"]
    bm = [r for r in rows if r["kind"] == "bitmatmul"]
    sm = [r for r in rows if r["kind"] == "spmm"]
    fw = [r for r in rows if r["kind"] == "fused_walk"]

    word_slope, word_icpt = _line_fit([r["word_ops"] for r in bm], [r["t_ns"] for r in bm])
    updates: Dict[str, object] = {
        "c_word_op": word_slope,
        "source": "calibrated",
        "device": str(meas["device"]),
    }
    launch = [word_icpt] + [float(r["t_ns"]) for r in fw]
    updates["c_launch_overhead"] = max(float(np.median(launch)), 1.0)
    if sm:
        spmm_slope, spmm_icpt = _line_fit([r["flops"] for r in sm], [r["t_ns"] for r in sm])
        updates["c_spmm_flop"] = spmm_slope
        updates["c_spmm_overhead"] = max(spmm_icpt, 1.0)
        # the CSR/bitplane crossover, from the same identity as the default
        thr = float(np.sqrt(word_slope / (32.0 * spmm_slope)))
        updates["density_threshold"] = float(np.clip(thr, 1e-4, 0.5))
    return dataclasses.replace(base, **updates)


# ---------------------------------------------------------------------------
# Persistence (JSON, keyed by device name)
# ---------------------------------------------------------------------------
def save_constants(constants: Constants, path: str) -> str:
    """Merge one device's constants into the calibration file at ``path``."""
    data: Dict[str, object] = {"version": _FILE_VERSION, "devices": {}}
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
            if isinstance(old.get("devices"), dict):
                data["devices"] = old["devices"]
        except (OSError, ValueError):
            pass
    entry = dataclasses.asdict(constants)
    for k in ("source", "device", "path"):
        entry.pop(k, None)
    data["devices"][constants.device or device_kind()] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    return path


def load_constants(path: str, device: Optional[str] = None) -> Optional[Constants]:
    """Constants for device name ``device`` (default: :func:`device_kind`)
    from the calibration file at ``path``, or None.  Only an entry whose key
    is that name is taken: a file holding one other device's entry gives
    None."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    devices = data.get("devices")
    key = device or device_kind()
    if not isinstance(devices, dict) or key not in devices:
        return None
    fields = {f.name for f in dataclasses.fields(Constants)}
    kwargs = {k: v for k, v in devices[key].items() if k in fields}
    kwargs.update(source="calibrated", device=key, path=os.path.abspath(path))
    try:
        return Constants(**kwargs)
    except TypeError:
        return None


def calibrate(path: str, quick: bool = True, seed: int = 0, device=None) -> Constants:
    """Measure -> fit -> write to ``path``, in one call; installs nothing."""
    meas = run_microbench(quick=quick, seed=seed, device=device)
    fitted = fit_constants(meas)
    saved = save_constants(fitted, path)
    return dataclasses.replace(fitted, path=os.path.abspath(saved))


if __name__ == "__main__":  # pragma: no cover - CLI convenience
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="full density x shape grid (default: quick)")
    ap.add_argument("--path", required=True, help="calibration file to write")
    args = ap.parse_args()
    c = calibrate(path=args.path, quick=not args.full)
    print(f"calibrated for {c.device!r} -> {c.path}")
    for k, v in sorted(c.provenance().items()):
        print(f"  {k}: {v}")
