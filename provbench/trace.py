"""The window's device trace: ``torch.profiler`` over the whole window,
read from the profiler's raw events.

``summary`` gives the device's busy time (the union of the intervals in
which a kernel, copy or set ran), the number of kernels, the device
operations that took most time, and the idle gaps by what the host was
doing: each gap between device intervals is named after the innermost
host operation or benchmark span running at its middle."""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "provbench.window"
TOP = 10


class Window:
    """Times the window on the host clock and, with ``trace``, profiles it."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.t0 = self.t1 = None
        self._span = None

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._span = record_function(WINDOW)
            self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self._span.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _raw_events(prof) -> List[Tuple[str, int, int, bool]]:
    """(name, start ns, end ns, on the device) of every event, from the
    profiler's raw results (building its ``FunctionEvent`` tree takes
    minutes at a window's millions of events)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), dev))
    return out


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summary(win: Window) -> Optional[Dict[str, object]]:
    """None without a trace; ``kernels`` 0 where the device ran nothing."""
    if win.prof is None:
        return None
    events = _raw_events(win.prof)
    spans = [(s, e) for n, s, e, dev in events if not dev and n == WINDOW]
    w0, w1 = spans[0] if spans else (min(e[1] for e in events), max(e[2] for e in events))
    device = [(n, max(s, w0), min(e, w1)) for n, s, e, dev in events
              if dev and not n.startswith("provbench.") and e > w0 and s < w1]
    host = sorted((s, e, n) for n, s, e, dev in events
                  if not dev and n != WINDOW and e > w0 and s < w1)
    busy = _union((s, e) for _, s, e in device)
    by_op: Dict[str, int] = {}
    for n, s, e in device:
        by_op[n] = by_op.get(n, 0) + (e - s)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    # innermost host event covering each gap's middle: the live one that
    # started last (a max-heap on start, ended events dropped lazily)
    by_host: Dict[str, int] = {}
    heap: list = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op: Python)"
        by_host[name] = by_host.get(name, 0) + (g1 - g0)
    return {
        "kernels": sum(_is_kernel(n) for n, _, _ in device),
        "device_ops": len(device),
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "top_device": [[n[:160], ns / 1e9] for n, ns in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n[:160], ns / 1e9] for n, ns in
                      sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]],
        "longest_host": [[n[:80], (e - s) / 1e9] for s, e, n in
                         sorted((h for h in host if not h[2].startswith("provbench.")),
                                key=lambda h: h[0] - h[1])[:5]],
    }
