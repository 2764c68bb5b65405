"""Model configuration schema shared by all 10 assigned architectures.

The port's copy of the reference package's schema, field for field (plain
data; nothing here imports a framework).  A model is a stack of layers
described by a repeating BLOCK of :class:`LayerSpec`s plus an optional TAIL
(for layer counts not divisible by the block length, e.g. gemma3-1b's
26 = 4x6 + 2).  Each LayerSpec names its mixer (attention kinds / Mamba2
SSD) and its FFN (dense MLP / MoE).  The port's models run the layers of
:meth:`ModelConfig.layer_specs` one by one; ``remat`` and ``scan_layers``
are kept so that configurations compare equal across the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["LayerSpec", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer: mixer + ffn.

    mixer:  'attn' (full causal) | 'attn_local' (sliding window) |
            'attn_bidir' (encoder) | 'ssd' (Mamba2)
    ffn:    'mlp' | 'moe' | 'none' (ssd layers fold gating into the mixer in
            pure-Mamba stacks)
    """

    mixer: str = "attn"
    ffn: str = "mlp"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    block: Tuple[LayerSpec, ...] = (LayerSpec(),)
    tail: Tuple[LayerSpec, ...] = ()

    head_dim: Optional[int] = None   # default d_model // n_heads
    vocab_pad_multiple: int = 128    # embedding rows padded so the vocab dim
                                     # shards on any mesh (padded logits are
                                     # masked to -inf; labels never hit them)
    window: int = 0                  # sliding window for 'attn_local'
    qk_norm: bool = False            # chameleon / qwen3-style
    gated_mlp: bool = True           # SwiGLU; False = GELU 2-matrix (whisper)
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln (olmo)
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # encoder-decoder (whisper): encoder consumes STUB frame embeddings
    enc_layers: int = 0
    enc_seq: int = 0                 # 1500 for whisper

    # training-time defaults (overridable per shape at lowering time)
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots (save matmul outputs)
    scan_layers: bool = True

    # -- derived ---------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m if m else self.vocab

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_blocks(self) -> int:
        assert (self.n_layers - len(self.tail)) % len(self.block) == 0, (
            f"{self.name}: {self.n_layers} layers != k*{len(self.block)} + {len(self.tail)}"
        )
        return (self.n_layers - len(self.tail)) // len(self.block)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def layer_specs(self) -> List[LayerSpec]:
        return list(self.block) * self.n_blocks + list(self.tail)

    def n_params(self) -> int:
        """Total parameter count (for MODEL_FLOPS = 6·N·D bookkeeping)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        per_mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        per_moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
        per_ssd = d * (2 * di + 2 * N + H) + self.ssm_conv * (di + 2 * N) \
            + 3 * H + di + di * d
        for spec in self.layer_specs():
            if spec.mixer in ("attn", "attn_local", "attn_bidir"):
                n += per_attn
            elif spec.mixer == "ssd":
                n += per_ssd
            if spec.ffn == "mlp":
                n += per_mlp
            elif spec.ffn == "moe":
                n += per_moe
            n += 2 * d  # the two norms
        if self.is_encdec:
            n += self.enc_layers * (per_attn + per_mlp + 2 * d)   # encoder
            n += self.n_layers * (per_attn + d)                   # cross-attn
        n += d  # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff
        n_moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        return self.n_params() - n_moe_layers * inactive
