"""Readings of the port's span recorder (``repro_torch.core.spans``) that a
traced run's replay keeps under ``rec["program"]``: every metric that
reads them divides by the replayed calls.  Each returns None where the
run kept no replay or the port has no such span or counter."""
from __future__ import annotations

from typing import Optional


def spans_named(rec: dict, name: str) -> list:
    """The aggregates of every path that ends in the span ``name``."""
    prog = rec.get("program")
    if not prog:
        return []
    return [s for path, s in prog["spans"].items() if path.rsplit("/", 1)[-1] == name]


def ms_per_call(rec: dict, name: str, field: str, how_only: bool = False) -> Optional[float]:
    """``field`` (``host_ns`` or ``device_ns``) of the spans ``name``, in
    ms a replayed call (a replayed Q7/Q8 call with ``how_only``)."""
    found = [s[field] for s in spans_named(rec, name) if s[field] is not None]
    calls = rec["program"]["how_calls" if how_only else "calls"] if found else 0
    if not calls:
        return None
    return sum(found) / 1e6 / calls


def count_per_call(rec: dict, counter: str) -> Optional[float]:
    """The counter ``counter`` over every span, a replayed call."""
    prog = rec.get("program")
    if not prog or not prog["calls"]:
        return None
    found = [s["counters"][counter] for s in prog["spans"].values() if counter in s["counters"]]
    return sum(found) / prog["calls"] if found else None
