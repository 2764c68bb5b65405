"""Join the current table with the tracked source ``right``."""


def apply(cur, sources, right, on, how="inner"):
    return cur.join(sources[right], on=on, how=how)
