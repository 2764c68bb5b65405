"""Core of the port: tensors, schema metadata, capture, index, queries."""
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.provtensor import ProvTensor

__all__ = ["ProvenanceIndex", "ProvTensor"]
