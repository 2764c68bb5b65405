"""Launchers of the port: :mod:`repro_torch.launch.serve`, the serving
launcher (local generation on a reduced config, with ``--tier`` lineage
probes through the micro-batching tier)."""
