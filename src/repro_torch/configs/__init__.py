"""Assigned-architecture configs: one module per arch, ``--arch <id>``."""
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
