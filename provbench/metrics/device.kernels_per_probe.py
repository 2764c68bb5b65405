"""Device kernels in the traced window per probe answered."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["kernels"] or not rec.get("probes"):
        return None
    return tr["kernels"] / rec["probes"]
