"""The plain reference: numpy semantics of the pipelines and of Q1-Q4.

It imports nothing of the port (``repro_torch``) nor of the JAX package,
and takes nothing the port made: it works the pipeline's relations out
again from the host tables the benchmark generated, and judges the port's
answers and captured relations against them.

``precision`` is ``"float32"`` (the configurations' stated precision) or
``"bfloat16"``: every value the reference holds is then rounded to
bfloat16, the control that the comparison must fail.
"""
import numpy as np


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bias = ((bits >> 16) & 1) + np.uint32(0x7FFF)
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def rounder(precision: str):
    if precision == "float32":
        return lambda a: np.asarray(a, dtype=np.float32)
    if precision == "bfloat16":
        return lambda a: round_bf16(np.asarray(a, dtype=np.float32))
    raise ValueError(f"unknown precision {precision!r}")
