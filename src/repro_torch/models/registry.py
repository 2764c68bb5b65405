"""Uniform model interface over the assembly modules: the decoder-only LM
(:mod:`repro_torch.models.lm`) and the encoder-decoder
(:mod:`repro_torch.models.whisper`), as ``repro.models.registry``.  The
port's interface adds ``cast_params``, the one-time weight cast the
serving engine makes."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, whisper

__all__ = ["Model", "get_model"]


class Model(NamedTuple):
    init_params: Callable
    forward: Callable       # full-sequence logits
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    cast_params: Callable


_LM = Model(lm.init_params, lm.forward, lm.prefill, lm.decode_step, lm.init_cache,
            lm.cast_params)
_ENCDEC = Model(whisper.init_params, whisper.forward, whisper.prefill, whisper.decode_step,
                whisper.init_cache, whisper.cast_params)


def get_model(cfg: ModelConfig) -> Model:
    return _ENCDEC if cfg.is_encdec else _LM
