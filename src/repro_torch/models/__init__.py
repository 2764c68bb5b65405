"""Models of the port: the decoder-only LM (:mod:`repro_torch.models.lm`,
with the SSD and MoE layers of :mod:`.ssd` and :mod:`.moe`) and the
encoder-decoder (:mod:`repro_torch.models.whisper`) on the shared
components of :mod:`repro_torch.models.common`, the uniform interface
:func:`~repro_torch.models.registry.get_model`, and
:func:`~repro_torch.models.carry.params_from_numpy`, which carries a
parameter tree given as numpy arrays into the port's modules
(:func:`~repro_torch.models.carry.params_to_numpy` carries it back).  The
``forward`` functions are differentiable, for training (:mod:`repro_torch.train`);
prefill, decode and the encoder run without a gradient.  Activations carry
the sharding hints of :mod:`repro_torch.models.pshard`."""
