"""Host time of the port's ``query.attr_hop`` spans (an attribute hop: the
row-mask move and the ``bitmatmul`` contraction) a call of the traced
run's replay, ms."""
from provbench.portspans import ms_per_call


def read(rec):
    return ms_per_call(rec, "query.attr_hop", "host_ns")
