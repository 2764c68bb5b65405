"""Probes answered in the window over the window's length."""


def read(rec):
    if "probes" not in rec or not rec.get("window_s"):
        return None
    return rec["probes"] / rec["window_s"]
