"""The port's span recorder: named spans and counters, aggregated in memory
by path while :func:`recording` is open.

    with spans.recording() as rec:
        session.run(plan)
    rec.summary()["spans"]["session.run/session.extract"]["host_ns"]

Off (the default), :func:`span` costs one module-global check and hands
back one shared no-op context, and :func:`count` returns at once: no
allocation, no clock read, no torch call.

On, a span reads ``time.perf_counter_ns`` at each end and keeps its parent
on a thread-local stack of open spans, so that threads keep paths of their
own.  When it closes its time goes to its path's aggregate (``"a/b"`` for a
span ``b`` opened inside ``a``): count, host ns, self ns (its time less the
part its children cover), device ns and counters.  A span given a CUDA
``device`` also records a ``torch.cuda.Event`` pair on the current stream;
the pair is read in :meth:`Recording.summary`, never synchronised inside
the span.  A span on any other device takes its host time as its device
time, and a span given no device has none.  While a ``torch.profiler``
session runs, each span also opens a ``record_function`` range of its own
name, which puts the spans on the profiler's clock.

:data:`HOST_SYNCS` counts the places where the host waits for the card: a
``nonzero``, a boolean index, a ``unique``, a ``bincount`` (two reads), an
``.item()``, ``bool()``, ``int()``, ``float()``, ``.tolist()`` or ``.cpu()`` of
a device tensor, and a copy from the host.  The query and capture paths
count each such read where it happens, on every device, so that a run on
the CPU counts what the same calls wait for on the card; a copy from the
host counts only where there is one, and on the CPU there is none.

A values plan's batched recomputation runs in one ``recompute.fetch`` span
on the index's device (``provenance/session.py``), which counts
``recompute_ops`` (ops re-executed) and ``recompute_rows`` (the rows they
ran on; both named in ``core/recompute.py``) beside its ``host_syncs``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["HOST_SYNCS", "Recording", "count", "count_host_copy", "recording", "span"]

HOST_SYNCS = "host_syncs"

_rec: Optional["Recording"] = None      # the open recording; None = off
_tls = threading.local()
_FOLD_AT = 4096                         # pending event pairs before a fold
_OFF = contextlib.nullcontext()         # what span() hands back while off


class _Agg:
    __slots__ = ("count", "host_ns", "self_ns", "device_ns", "counters")

    def __init__(self):
        self.count = 0
        self.host_ns = 0
        self.self_ns = 0
        self.device_ns = None
        self.counters: Dict[str, int] = {}


class Recording:
    """What one :func:`recording` block gathered; read :meth:`summary`
    after the block has ended."""

    def __init__(self):
        self._lock = threading.Lock()
        self._agg: Dict[str, _Agg] = {}
        self._events: List[tuple] = []      # (path, start event, end event)
        self._loose: Dict[str, int] = {}    # counts made outside every span

    def _close(self, sp: "_Span", host_ns: int, end_event) -> None:
        with self._lock:
            agg = self._agg.get(sp.path)
            if agg is None:
                agg = self._agg[sp.path] = _Agg()
            agg.count += 1
            agg.host_ns += host_ns
            agg.self_ns += host_ns - sp.child_ns
            if sp.counters:
                for k, n in sp.counters.items():
                    agg.counters[k] = agg.counters.get(k, 0) + n
            if end_event is not None:
                self._events.append((sp.path, sp.start_event, end_event))
                if agg.device_ns is None:
                    agg.device_ns = 0
                if len(self._events) >= _FOLD_AT:
                    self._fold(wait=False)
            elif sp.device is not None:
                agg.device_ns = (agg.device_ns or 0) + host_ns

    def _fold(self, wait: bool) -> None:
        """Adds the pairs whose end the card has passed to their paths'
        device ns; with ``wait``, every pair, each end waited for first."""
        left = []
        for path, e0, e1 in self._events:
            if wait:
                e1.synchronize()
            if wait or e1.query():
                self._agg[path].device_ns += round(e0.elapsed_time(e1) * 1e6)
            else:
                left.append((path, e0, e1))
        self._events = left

    def _count_loose(self, name: str, n: int) -> None:
        with self._lock:
            self._loose[name] = self._loose.get(name, 0) + n

    def summary(self) -> Dict[str, dict]:
        """``{"spans": {path: {"count", "host_ns", "self_ns", "device_ns",
        "counters"}}, "loose": {counter: n}}``; ``device_ns`` is None for a
        span given no device, ``loose`` holds the counts made outside every
        span."""
        with self._lock:
            self._fold(wait=True)
            return {
                "spans": {p: {"count": a.count, "host_ns": a.host_ns, "self_ns": a.self_ns,
                              "device_ns": a.device_ns, "counters": dict(a.counters)}
                          for p, a in self._agg.items()},
                "loose": dict(self._loose),
            }


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    __slots__ = ("name", "device", "rec", "path", "child_ns", "counters", "t0",
                 "start_event", "range")

    def __init__(self, name: str, device, rec: Recording):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.rec = rec
        self.child_ns = 0
        self.counters: Optional[Dict[str, int]] = None
        self.start_event = self.range = None

    def __enter__(self):
        st = _stack()
        self.path = f"{st[-1].path}/{self.name}" if st else self.name
        st.append(self)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        end_event = None
        if self.start_event is not None:
            end_event = torch.cuda.Event(enable_timing=True)
            end_event.record()
        if self.range is not None:
            self.range.__exit__(*exc)
        st = _stack()
        st.pop()
        host_ns = t1 - self.t0
        if st:
            st[-1].child_ns += host_ns
        self.rec._close(self, host_ns, end_event)
        return False


def span(name: str, device=None):
    """A context that records ``name`` under the innermost open span while
    a :func:`recording` is open; ``device`` is where its work runs."""
    if _rec is None:
        return _OFF
    return _Span(name, device, _rec)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the innermost open span's counter ``name`` while a
    :func:`recording` is open."""
    if _rec is None:
        return
    st = _stack()
    if st:
        c = st[-1].counters
        if c is None:
            c = st[-1].counters = {}
        c[name] = c.get(name, 0) + n
    else:
        _rec._count_loose(name, n)


def count_host_copy(device, n: int = 1) -> None:
    """Counts ``n`` :data:`HOST_SYNCS` for ``n`` copies from the host to
    ``device``, where there is one: a tensor or list moved there, a list
    index, a Python scalar stored through a tensor index.  The CPU makes
    none."""
    if _rec is None or torch.device(device).type == "cpu":
        return
    count(HOST_SYNCS, n)


@contextlib.contextmanager
def recording():
    """Turns the recorder on for the ``with`` block, starting from empty;
    ``as`` gives the :class:`Recording`.  A recording opened inside another
    gathers alone until it ends, and the outer one resumes."""
    global _rec
    prev, rec = _rec, Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = prev
