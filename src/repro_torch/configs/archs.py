"""The 10 assigned architectures — exact published configs + reduced smokes.

Every entry is from the assignment table (sources bracketed there).  The
``smoke_*`` variants keep the FAMILY structure (same block pattern, same
mixer kinds, same MoE/SSD topology) at toy width/depth so one forward
step runs on CPU in milliseconds.  The dense FULL configs that fit one card
(olmo-1b, gemma3-1b) run at their published widths on it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

__all__ = ["ARCHS", "SMOKES"]

A = LayerSpec(mixer="attn", ffn="mlp")
AL = LayerSpec(mixer="attn_local", ffn="mlp")
AM = LayerSpec(mixer="attn", ffn="moe")
SSD = LayerSpec(mixer="ssd", ffn="none")
SSD_MLP = LayerSpec(mixer="ssd", ffn="mlp")
SSD_MOE = LayerSpec(mixer="ssd", ffn="moe")


# ---------------------------------------------------------------------------
# Dense transformers
# ---------------------------------------------------------------------------
gemma3_12b = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262_144,
    block=(AL, AL, AL, AL, AL, A),       # 5 local : 1 global
    window=1024, rope_theta=1_000_000.0,
)

llama3_405b = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128_256,
    block=(A,), rope_theta=500_000.0, tie_embeddings=False,
)

gemma3_1b = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262_144,
    block=(AL, AL, AL, AL, AL, A),       # 4 blocks of 6 ...
    tail=(AL, AL),                       # ... + 2 trailing locals (26 = 4*6+2)
    window=1024, rope_theta=1_000_000.0,
)

olmo_1b = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50_304,
    block=(A,), norm="nonparam_ln",      # OLMo's non-parametric LN
)

# ---------------------------------------------------------------------------
# Audio (enc-dec; conv/mel frontend STUBBED — input_specs provides frames)
# ---------------------------------------------------------------------------
whisper_small = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51_865,
    block=(A,), enc_layers=12, enc_seq=1500,
    gated_mlp=False,                     # whisper uses plain GELU MLPs
)

# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
qwen3_moe = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151_936,
    block=(AM,), n_experts=128, top_k=8,
    head_dim=128, qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)

dbrx = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100_352,
    block=(AM,), n_experts=16, top_k=4,
    rope_theta=500_000.0, tie_embeddings=False,
)

# ---------------------------------------------------------------------------
# SSM / hybrid
# ---------------------------------------------------------------------------
mamba2_370m = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50_280,
    block=(SSD,), ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

jamba_15_large = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65_536,
    # 1 attn : 7 mamba per block of 8 (attn at index 4), MoE every 2nd layer
    block=(SSD_MLP, SSD_MOE, SSD_MLP, SSD_MOE, AM, SSD_MOE, SSD_MLP, SSD_MOE),
    n_experts=16, top_k=2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

# ---------------------------------------------------------------------------
# VLM (early fusion; VQ image tokens share the text stream — frontend STUB)
# ---------------------------------------------------------------------------
chameleon_34b = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65_536,
    block=(A,), qk_norm=True,            # chameleon's QK-norm stabilization
)

ARCHS = {
    "gemma3-12b": gemma3_12b,
    "llama3-405b": llama3_405b,
    "gemma3-1b": gemma3_1b,
    "olmo-1b": olmo_1b,
    "whisper-small": whisper_small,
    "qwen3-moe-235b-a22b": qwen3_moe,
    "dbrx-132b": dbrx,
    "mamba2-370m": mamba2_370m,
    "jamba-1.5-large-398b": jamba_15_large,
    "chameleon-34b": chameleon_34b,
}


# ---------------------------------------------------------------------------
# Reduced smoke variants (same family topology, toy size, CPU-runnable)
# ---------------------------------------------------------------------------
def _smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    base = dict(
        n_layers=len(cfg.block) * 2 + len(cfg.tail),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16 if cfg.head_dim else None,
        window=8 if cfg.window else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=2 if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        remat=False,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


SMOKES = {
    name: _smoke(cfg) for name, cfg in ARCHS.items()
}
# gemma3-1b keeps its tail so the remainder path is exercised:
SMOKES["gemma3-1b"] = _smoke(ARCHS["gemma3-1b"], n_layers=2 * 6 + 2)
