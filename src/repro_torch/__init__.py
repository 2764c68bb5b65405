"""PyTorch/CUDA port of the provenance index (the ``repro`` package's twin).

Same layout as ``repro``: :mod:`repro_torch.core` (tensors, capture, index,
record-level queries), :mod:`repro_torch.dataprep` (tables, tracked ops,
use cases), :mod:`repro_torch.provenance` (builder -> plan -> session) and
:mod:`repro_torch.kernels` (the hand-written Hopper kernels beside their
plain PyTorch versions), the LM substrate: :mod:`repro_torch.models`,
:mod:`repro_torch.serve`, :mod:`repro_torch.train` and
:mod:`repro_torch.data` (training data with provenance), and the mesh
layer over ``torch.distributed``: :mod:`repro_torch.launch.mesh`,
:mod:`repro_torch.launch.sharding`, :mod:`repro_torch.models.pshard` and
:mod:`repro_torch.core.distributed`.

Every entry point takes an explicit ``device``; ``None`` means CUDA and
raises where there is no CUDA device.  The package imports ``torch`` and
never ``jax`` or ``repro``.
"""
