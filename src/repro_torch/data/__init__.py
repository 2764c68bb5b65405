"""Training data with provenance: :mod:`.pipeline`, the corpus -> filter ->
dedup -> pack -> batch dataflow captured in a ``ProvenanceIndex``."""
from repro_torch.data.pipeline import CorpusConfig, TokenPipeline, make_corpus

__all__ = ["CorpusConfig", "TokenPipeline", "make_corpus"]
