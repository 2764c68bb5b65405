"""Launchers and the mesh layer of the port: :mod:`repro_torch.launch.serve`,
the serving launcher (local generation on a reduced config, with ``--tier``
lineage probes through the micro-batching tier),
:mod:`repro_torch.launch.train`, the training launcher (a reduced config
trained on the provenance-carrying data pipeline, with async checkpoints
and resume), :mod:`repro_torch.launch.shapes` (the 40 shape cells),
:mod:`repro_torch.launch.mesh` (process groups and device meshes),
:mod:`repro_torch.launch.sharding` (partition rules and DTensor
placements) and the dry-run accounting of full configs on the production
meshes: :mod:`repro_torch.launch.dryrun` (every cell),
:mod:`repro_torch.launch.hloanal` (the per-device counter) and
:mod:`repro_torch.launch.perf` (optimizer and layout variants)."""
