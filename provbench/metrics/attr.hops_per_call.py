"""The port's ``attr_hops`` counter (one a ``bitmatmul`` dispatch of the
attribute walk) a call of the traced run's replay."""
from provbench.portspans import count_per_call


def read(rec):
    return count_per_call(rec, "attr_hops")
