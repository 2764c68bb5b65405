"""Device time of the port's ``recompute.fetch`` spans (a CUDA event pair
each, from its start to its end on the stream) a call of the traced
run's replay, ms."""
from provbench.portspans import ms_per_call


def read(rec):
    return ms_per_call(rec, "recompute.fetch", "device_ns")
