"""Config for --arch chameleon-34b (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "chameleon-34b"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
