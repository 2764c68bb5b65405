"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from repro_torch.configs.archs import ARCHS, SMOKES
from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config"]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in SMOKES:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(SMOKES)}")
    return SMOKES[arch]
