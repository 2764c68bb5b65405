"""Config for --arch dbrx-132b (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "dbrx-132b"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
