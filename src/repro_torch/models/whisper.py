"""Whisper-style encoder-decoder backbone (audio family).

The port of ``repro.models.whisper``.  The conv/mel frontend is a stub, as
in the reference: the encoder takes precomputed frame embeddings
(B, enc_seq, d_model).  A bidirectional encoder (no RoPE), then a causal
decoder with per-layer cross-attention to the encoder output.  Positions
are the reference's parameter-free sinusoid (float32 angles
``pos / 10000^(2i/d)``, sin then cos) added to the inputs, and the
decoder's self-attention ALSO applies RoPE, as the reference's does
(``use_rope = kind != "bidir"``); cross-attention has neither RoPE nor a
mask.  The MLPs are the 2-matrix GELU (tanh form).

Parameters: ``embed`` (padded vocab, d), ``enc_layers`` and ``dec_layers``
(one module per layer; the reference stacks them on a layer axis),
``enc_norm``, ``final_norm``; the head is the embedding's transpose.  The
decode cache is a list with one dict per decoder layer: the self-attention
K/V (``k``, ``v``: B, s_max, KV, hd) and the cross K/V (``ck``, ``cv``: B,
enc_seq, KV, hd), computed once by :func:`encode_into_cache`.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models import pshard as PS

__all__ = ["Whisper", "init_params", "cast_params", "encode", "forward", "prefill",
           "decode_step", "init_cache", "encode_into_cache"]

Cache = List[Dict[str, torch.Tensor]]


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.pre_norm = C.Norm(cfg, cfg.d_model, device)
        self.attn = C.Attn(cfg, device)
        self.post_norm = C.Norm(cfg, cfg.d_model, device)
        self.mlp = C.MLP(cfg, device)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.pre_norm = C.Norm(cfg, cfg.d_model, device)
        self.attn = C.Attn(cfg, device)
        self.cross_norm = C.Norm(cfg, cfg.d_model, device)
        self.cross = C.Attn(cfg, device, cross=True)
        self.post_norm = C.Norm(cfg, cfg.d_model, device)
        self.mlp = C.MLP(cfg, device)


class Whisper(nn.Module):
    """Built on ``device`` with its parameters uninitialised:
    :func:`init_params` draws them, ``carry`` copies them."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.embed = C._param((cfg.padded_vocab, cfg.d_model), device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device) for _ in range(cfg.enc_layers))
        self.enc_norm = C.Norm(cfg, cfg.d_model, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = C.Norm(cfg, cfg.d_model, device)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Whisper:
    """Random float32 parameters on ``device`` (``None``: the card, raising
    without one), drawn from ``generator`` on the same device: the
    reference's distributions (normal embedding over sqrt(d_model), zero
    norm scales), not its values."""
    dev = resolve_device(device)
    p = Whisper(cfg, device="meta")
    p.embed = C._param((cfg.padded_vocab, cfg.d_model), dev)
    p.embed.normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    for layer in list(p.enc_layers) + list(p.dec_layers):
        for name in ("pre_norm", "cross_norm", "post_norm"):
            if hasattr(layer, name):
                setattr(layer, name, C.init_norm(cfg, cfg.d_model, dev))
        layer.attn = C.init_attn(cfg, generator, dev)
        if hasattr(layer, "cross"):
            layer.cross = C.init_attn(cfg, generator, dev, cross=True)
        layer.mlp = C.init_mlp(cfg, generator, dev)
    p.enc_norm = C.init_norm(cfg, cfg.d_model, dev)
    p.final_norm = C.init_norm(cfg, cfg.d_model, dev)
    return p


def cast_params(cfg: ModelConfig, params: Whisper, dtype: torch.dtype,
                device=None) -> Whisper:
    """``params`` on ``device`` with every weight in ``dtype`` and the norm
    scales in float32, in one copy (``lm.cast_params``' twin)."""
    return C.cast_module(params, Whisper(cfg, device="meta"), dtype, resolve_device(device))


def _sinusoid(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """(S, d) of positions (S,): sin of the float32 angles, then cos."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = positions.float()[:, None] / torch.pow(10_000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _logits(cfg: ModelConfig, params: Whisper, x: torch.Tensor) -> torch.Tensor:
    return C.logits_block(cfg, params.final_norm.scale, params.embed, x, tied=True)


def _embed(cfg: ModelConfig, params: Whisper, tokens: torch.Tensor, dtype) -> torch.Tensor:
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = C.pin_grad(params.embed)[tokens].to(dtype) + _sinusoid(pos, cfg.d_model, dtype)[None]
    return PS.hint(x, "dp", None, None)


# ---------------------------------------------------------------------------
# Encoder (frames already embedded by the stub frontend)
# ---------------------------------------------------------------------------
def _enc_layer(cfg: ModelConfig, layer: EncLayer, q_chunk: int, x: torch.Tensor) -> torch.Tensor:
    x = x + C.attn_block(cfg, layer.pre_norm.scale, layer.attn, x, "bidir", q_chunk)[0]
    return x + C.mlp_block(cfg, layer.post_norm.scale, layer.mlp, x)


def _encode(cfg: ModelConfig, params: Whisper, frames: torch.Tensor,
            q_chunk: int) -> torch.Tensor:
    """The differentiable encoder; with ``cfg.remat`` each layer is
    rematerialised, saving nothing (the reference's policy for this family
    whatever ``cfg.remat_policy`` says)."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = PS.hint(frames + _sinusoid(pos, cfg.d_model, frames.dtype)[None], "dp", None, None)
    for layer in params.enc_layers:
        x = C.remat_call(cfg, functools.partial(_enc_layer, cfg, layer, q_chunk), x,
                         policy="nothing")
    return C.norm_apply(cfg, x, params.enc_norm.scale)


@torch.no_grad()
def encode(cfg: ModelConfig, params: Whisper, frames: torch.Tensor,
           q_chunk: int = 0) -> torch.Tensor:
    """frames (B, S_enc, D), in the activations' dtype -> (B, S_enc, D)."""
    return _encode(cfg, params, frames, q_chunk)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _dec_layer(cfg: ModelConfig, layer: DecLayer, enc: torch.Tensor, q_chunk: int, rot,
               x: torch.Tensor) -> torch.Tensor:
    x = x + C.attn_block(cfg, layer.pre_norm.scale, layer.attn, x, "causal", q_chunk, rot)[0]
    x = x + C.cross_block(cfg, layer.cross_norm.scale, layer.cross, x, enc)
    return x + C.mlp_block(cfg, layer.post_norm.scale, layer.mlp, x)


def forward(cfg: ModelConfig, params: Whisper, frames: torch.Tensor, tokens: torch.Tensor,
            q_chunk: int = 0, dtype=torch.bfloat16) -> torch.Tensor:
    """Causal logits (B, S, V) float32 for tokens (B, S) after frames
    (B, enc_seq, D), on the params' device: the training forward,
    differentiable through the encoder.  The embedding is cast before the
    gather, as the reference does; with ``cfg.remat`` every encoder and
    decoder layer is rematerialised, saving nothing."""
    enc = _encode(cfg, params, frames.to(dtype), q_chunk)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = C.pin_grad(params.embed).to(dtype)[tokens] + _sinusoid(pos, cfg.d_model, dtype)[None]
    x = PS.hint(x, "dp", None, None)
    rot = C.rope_angles(pos[None, :], cfg.hd, cfg.rope_theta)
    for layer in params.dec_layers:
        x = C.remat_call(cfg, functools.partial(_dec_layer, cfg, layer, enc, q_chunk, rot), x,
                         policy="nothing")
    return _logits(cfg, params, x)


def _prefill_layers(cfg: ModelConfig, params: Whisper, frames: torch.Tensor,
                    tokens: torch.Tensor, q_chunk: int, dtype) -> Tuple[torch.Tensor, Cache]:
    enc = encode(cfg, params, frames.to(dtype), q_chunk)
    x = _embed(cfg, params, tokens, dtype)
    rot = C.rope_angles(torch.arange(tokens.shape[1], device=tokens.device)[None, :], cfg.hd,
                        cfg.rope_theta)
    caches = []
    for layer in params.dec_layers:
        out, kv = C.attn_block(cfg, layer.pre_norm.scale, layer.attn, x, "causal", q_chunk, rot)
        x = x + out
        ckv = C.cross_kv_block(cfg, layer.cross, enc)
        x = x + C.cross_decode_block(cfg, layer.cross_norm.scale, layer.cross, x, ckv)
        x = x + C.mlp_block(cfg, layer.post_norm.scale, layer.mlp, x)
        caches.append({**kv, **ckv})
    return x, caches


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Whisper, frames: torch.Tensor, tokens: torch.Tensor,
            q_chunk: int = 0, dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """The encoder and the whole prompt: last-position logits (B, V) and
    each decoder layer's K/V at prompt length with its cross K/V."""
    x, caches = _prefill_layers(cfg, params, frames, tokens, q_chunk, dtype)
    return _logits(cfg, params, x[:, -1:, :])[:, 0, :], caches


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Zeroed self and cross K/V per decoder layer on ``device`` (``None``:
    the card, raising without one)."""
    dev = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.hd
    shapes = {"k": s_max, "v": s_max, "ck": cfg.enc_seq, "cv": cfg.enc_seq}
    return [{name: torch.zeros((batch, n, kv, hd), dtype=dtype, device=dev)
             for name, n in shapes.items()} for _ in range(cfg.n_layers)]


@torch.no_grad()
def encode_into_cache(cfg: ModelConfig, params: Whisper, frames: torch.Tensor, cache: Cache,
                      q_chunk: int = 0) -> Cache:
    """Run the encoder over frames (in the activations' dtype) and write
    each decoder layer's cross K/V into ``cache`` in place, cast to the
    cache's dtype: audio is served without prefilling any decoder token."""
    enc = encode(cfg, params, frames, q_chunk)
    for layer, lc in zip(params.dec_layers, cache):
        ckv = C.cross_kv_block(cfg, layer.cross, enc)
        lc["ck"].copy_(ckv["ck"])
        lc["cv"].copy_(ckv["cv"])
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Whisper, token: torch.Tensor, pos: int, cache: Cache,
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """One step: token (B,) at position ``pos`` (an int) -> (B, V) float32
    logits for the NEXT token.  The self K/V is written in place; a position
    past the cache raises."""
    pos = int(pos)
    p = torch.full((1,), pos, device=token.device)
    x = params.embed[token[:, None]].to(dtype) + _sinusoid(p, cfg.d_model, dtype)[None]
    x = PS.hint(x, "dp", None, None)
    rot = C.rope_angles(p[None, :], cfg.hd, cfg.rope_theta)
    for layer, lc in zip(params.dec_layers, cache):
        x = x + C.attn_decode_block(cfg, layer.pre_norm.scale, layer.attn, x, lc, pos, "causal",
                                    rot)
        x = x + C.cross_decode_block(cfg, layer.cross_norm.scale, layer.cross, x, lc)
        x = x + C.mlp_block(cfg, layer.post_norm.scale, layer.mlp, x)
    return _logits(cfg, params, x)[:, 0, :], cache
