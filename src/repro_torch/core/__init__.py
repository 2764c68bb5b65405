"""Core of the port: tensors, schema metadata, capture, index, queries.

``ProvenanceIndex`` and ``ProvTensor`` are resolved on first access, so
that importing a leaf module (``repro_torch.dataprep.table`` needs
``core.device``) does not pull in ``core.pipeline``, which imports it
back."""

__all__ = ["ProvenanceIndex", "ProvTensor"]


def __getattr__(name: str):
    if name == "ProvenanceIndex":
        from repro_torch.core.pipeline import ProvenanceIndex

        return ProvenanceIndex
    if name == "ProvTensor":
        from repro_torch.core.provtensor import ProvTensor

        return ProvTensor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
