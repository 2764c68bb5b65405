"""Config for --arch whisper-small (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "whisper-small"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
