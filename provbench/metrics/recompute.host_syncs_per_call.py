"""The port's ``host_syncs`` counted inside its ``recompute.fetch`` spans
(each read of the device the recomputation waits for) a call of the
traced run's replay."""
from provbench.portspans import spans_named


def read(rec):
    found = spans_named(rec, "recompute.fetch")
    if not found or not rec["program"]["calls"]:
        return None
    return sum(s["counters"].get("host_syncs", 0) for s in found) / rec["program"]["calls"]
