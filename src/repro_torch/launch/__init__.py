"""Launchers of the port: :mod:`repro_torch.launch.serve`, the serving
launcher (local generation on a reduced config, with ``--tier`` lineage
probes through the micro-batching tier), and :mod:`repro_torch.launch.train`,
the training launcher (a reduced config trained on the provenance-carrying
data pipeline, with async checkpoints and resume)."""
