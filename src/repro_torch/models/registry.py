"""Uniform model interface over the assembly modules.

The decoder-only LM is ported; the encoder-decoder model (whisper) is not
yet, and asking for it raises (ROADMAP A13)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

__all__ = ["Model", "get_model"]


class Model(NamedTuple):
    init_params: Callable
    forward: Callable       # full-sequence logits
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


_LM = Model(lm.init_params, lm.forward, lm.prefill, lm.decode_step, lm.init_cache)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet (ROADMAP A13, whisper)")
    return _LM
