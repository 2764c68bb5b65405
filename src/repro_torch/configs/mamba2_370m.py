"""Config for --arch mamba2-370m (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "mamba2-370m"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
