"""Seconds from the start of the process to the window: imports, the
kernels' build or load, tables made and moved, capture and warm-up."""


def read(rec):
    return rec.get("setup_s")
