"""Host time of the port's ``query.how_trace`` spans (a hop's trace read to
the host) a Q7/Q8 call of the traced run's replay, ms."""
from provbench.portspans import ms_per_call


def read(rec):
    return ms_per_call(rec, "query.how_trace", "host_ns", how_only=True)
