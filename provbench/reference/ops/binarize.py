"""1 where ``col`` exceeds the threshold, else 0."""
from provbench.reference.ops import value_transform


def apply(cur, sources, rnd, col, threshold):
    return value_transform.apply(cur, sources, rnd, col, "binarize", threshold=threshold)
