"""Config for --arch qwen3-moe-235b-a22b (exact assignment spec; see archs.py)."""
from repro_torch.configs.archs import ARCHS, SMOKES

ARCH_ID = "qwen3-moe-235b-a22b"
CONFIG = ARCHS[ARCH_ID]
SMOKE = SMOKES[ARCH_ID]
