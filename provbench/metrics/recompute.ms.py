"""Host time of the port's ``recompute.fetch`` spans (a values plan's one
batched recomputation of its target's rows) a call of the traced run's
replay, ms."""
from provbench.portspans import ms_per_call


def read(rec):
    return ms_per_call(rec, "recompute.fetch", "host_ns")
