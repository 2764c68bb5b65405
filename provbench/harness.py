"""One run of one cell: set-up, the measured window, the readers of the
metrics, and the comparison with the plain reference.

Everything a cell needs is found by name: its configuration's file
(``BENCHMARK.json``), its mix (``traffic/<mix>.json``), the mix's loop
(``loops/<loop>.py``), the tables' generators (``tables/<name>.py``)
and each metric's reader (``metrics/<metric>.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from provbench import hosttable, trace
from provbench.hosttable import HostTable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a loop reads and fills in; ``rec`` is what the readers read."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    mix: dict
    tables: Dict[str, HostTable]
    rec: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)
    judge: dict = dataclasses.field(default_factory=dict)   # host data for check
    win: Optional[trace.Window] = None

    def rng(self, stream: int):
        return hosttable.rng(self.seed, stream)

    def window(self) -> trace.Window:
        self.win = trace.Window(self.trace)
        return self.win

    @contextlib.contextmanager
    def span(self, name: str):
        """The benchmark's own span around a call into one layer: host
        clock, appended to ``rec["spans"][name]``; a profiler range too
        when tracing."""
        spans = self.rec.setdefault("spans", {}).setdefault(name, [])
        rf = None
        if self.trace:
            from torch.profiler import record_function

            rf = record_function(f"provbench.{name}")
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            spans.append(time.perf_counter() - t)
            if rf is not None:
                rf.__exit__(None, None, None)


class GcPauses:
    """The garbage collector's pauses while in the ``with`` block."""

    def __init__(self):
        self.pauses: Dict[int, List[float]] = {0: [], 1: [], 2: []}
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False

    def note(self) -> str:
        return "gc pauses in the window: " + ", ".join(
            f"gen{g} {len(p)} (max {max(p, default=0) * 1e3:.1f} ms, sum {sum(p) * 1e3:.1f})"
            for g, p in self.pauses.items())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(f"provbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(b: dict, name: str) -> dict:
    for c in b["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def make_tables(config: dict, seed: int) -> Dict[str, HostTable]:
    rng = hosttable.rng(seed, hosttable.TABLES)
    out: Dict[str, HostTable] = {}
    for spec in config["tables"]:
        gen = importlib.import_module(f"provbench.tables.{spec['generator']}")
        out.update(gen.make(spec["params"], rng))
    return out


def settle(device) -> None:
    """Garbage collected, the device idle and its unused cached blocks
    released, so that two allocator readings compare."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """The top-level names of loaded modules that the benchmark's process
    may not hold: the JAX package and JAX (whole names: ``repro_torch``
    is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics_for(b: dict, cell: str, trace_on: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace_on`` false) or per-layer ones."""
    group = b["per_layer"] if trace_on else b["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metrics(b: dict, cell: str, trace_on: bool, rec: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics_for(b, cell, trace_on):
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, device,
             t_start: Optional[float] = None, config: Optional[dict] = None,
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object.  ``config``
    replaces the cell's own (tests run cut sizes on the CPU);
    ``control`` also reads the control (the reference in bfloat16 in the
    port's place) on the same sample, under ``control``."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    b = bench()
    w = cell_of(b, cell)
    config = config or config_of(b, w["config"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    loop = importlib.import_module(f"provbench.loops.{mix['loop']}")
    run = Run(cell, seed, seconds, trace_on, device, config, mix,
              make_tables(config, seed))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    st = loop.setup(run)
    run.rec["setup_s"] = time.perf_counter() - t_start
    pauses = GcPauses()
    with pauses:
        loop.window(run, st)
    run.notes.append(pauses.note())
    run.rec["trace"] = trace.summary(run.win)
    dev = device_info(device)
    loop.finish(run, st)
    del st
    settle(device)
    checks = loop.check(run)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": read_metrics(b, cell, trace_on, run.rec),
        "device": dev,
    }
    tr = run.rec["trace"]
    if tr is not None:
        run.notes.append("longest host ops in the window: " + ", ".join(
            f"{n} {sec * 1e3:.1f} ms" for n, sec in tr["longest_host"]))
    if trace_on:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["top_device"], "idle_gaps": tr["idle_gaps"]}
    result["notes"] = run.notes
    if control:
        result["control"] = loop.control(run)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
