"""Data-preparation substrate instrumented by the port (paper Table I ops)."""
from repro_torch.dataprep.table import Table

__all__ = ["Table"]
