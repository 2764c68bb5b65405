"""Config for --arch gemma3-12b (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "gemma3-12b"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
