"""Models of the port: the dense decoder-only LM (:mod:`repro_torch.models.lm`)
on the shared components of :mod:`repro_torch.models.common`, the uniform
interface :func:`~repro_torch.models.registry.get_model`, and
:func:`~repro_torch.models.carry.lm_params_from_numpy`, which carries a
parameter tree given as numpy arrays into the port's modules."""
