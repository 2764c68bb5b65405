"""Allocator bytes the captured index keeps on the device (the input
tables and the index held, less the tables alone) over the input tables'
bytes counted from their shapes (rows x columns x 4)."""


def read(rec):
    if "index_bytes" not in rec:
        return None
    return rec["index_bytes"] / rec["input_bytes"]
