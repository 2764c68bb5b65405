"""Device busy time in the traced window (the union of its kernels',
copies' and sets' intervals) per probe answered, ms."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_ops"] or not rec.get("probes"):
        return None
    return tr["busy_s"] * 1e3 / rec["probes"]
