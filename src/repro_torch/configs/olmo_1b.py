"""Config for --arch olmo-1b (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "olmo-1b"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
