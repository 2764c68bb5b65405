"""Decoder-only LM assembly: embeddings + layers + head.

The port of ``repro.models.lm`` for every layer kind the configs use: the
mixers ``attn``, ``attn_local`` and ``ssd`` (Mamba2, :mod:`.ssd`) and the
FFNs ``mlp``, ``moe`` (:mod:`.moe`) and ``none`` — dense llama3 / olmo /
chameleon, gemma3's 5-local : 1-global interleave with its tail, pure-SSD
mamba2, the jamba hybrid and the qwen3 / dbrx MoE stacks.

The reference stacks the BLOCK's parameters on a leading ``n_blocks`` axis
for ``lax.scan``; the port keeps one module per layer in ``LM.layers``, in
the order of :meth:`ModelConfig.layer_specs` (block ``j``'s layer ``i`` is
``layers[j * len(block) + i]``, tail layer ``i`` follows the blocks), and
the cache is a list with one dict per layer: ``{"k", "v"}`` for an
attention layer, ``{"state", "conv"}`` for an SSD layer.

Four entry points, as in the reference:
  forward(cfg, params, tokens)                 -> logits           (full sequence, differentiable)
  prefill(cfg, params, tokens)                 -> logits, caches
  decode_step(cfg, params, token, pos, cache)  -> logits, cache    (cache written in place)
  init_cache(cfg, batch, s_max, device=...)    -> cache

Activations carry the sharding hints of :mod:`.pshard` where the
reference's do: the embedding and the residual stream over "dp", the
logits' vocabulary over "tp", and the opt-in sequence-parallel residual
("sp"); each is the identity without a policy and an active mesh.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import pshard as PS
from repro_torch.models import ssd as S

__all__ = [
    "LM",
    "Layer",
    "init_params",
    "cast_params",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
]

Cache = List[Dict[str, torch.Tensor]]

_KIND = {"attn": "causal", "attn_local": "local", "attn_bidir": "bidir"}


def _check_spec(spec: LayerSpec) -> None:
    if (spec.mixer not in _KIND and spec.mixer != "ssd") \
            or spec.ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown layer {spec}")


class Layer(nn.Module):
    """``pre_norm``, the mixer (``attn`` or ``ssd``) and, with an FFN,
    ``post_norm`` and ``mlp`` or ``moe``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device=None) -> None:
        super().__init__()
        _check_spec(spec)
        self.spec = spec
        self.pre_norm = C.Norm(cfg, cfg.d_model, device)
        if spec.mixer == "ssd":
            self.ssd = S.SSD(cfg, device)
        else:
            self.attn = C.Attn(cfg, device)
        if spec.ffn != "none":
            self.post_norm = C.Norm(cfg, cfg.d_model, device)
            if spec.ffn == "moe":
                self.moe = M.MoE(cfg, device)
            else:
                self.mlp = C.MLP(cfg, device)


class LM(nn.Module):
    """``embed`` (padded vocab, d), ``final_norm``, ``layers`` and, untied,
    ``lm_head`` (d, padded vocab).  Built on ``device`` with its parameters
    uninitialised: :func:`init_params` draws them, ``carry`` copies them."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.embed = C._param((cfg.padded_vocab, cfg.d_model), device)
        self.final_norm = C.Norm(cfg, cfg.d_model, device)
        self.layers = nn.ModuleList(Layer(cfg, spec, device) for spec in cfg.layer_specs())
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = C._param((cfg.d_model, cfg.padded_vocab), device)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> LM:
    """Random float32 parameters on ``device`` (``None``: the card, raising
    without one), drawn from ``generator``, which lies on the same device.
    The distributions and scales are the reference's (normal embeddings and
    head over sqrt(d_model), zero norm scales); the values are not."""
    dev = resolve_device(device)
    p = LM(cfg, device="meta")          # the layout; each part is drawn below
    p.embed = C._param((cfg.padded_vocab, cfg.d_model), dev)
    p.embed.normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    p.final_norm = C.init_norm(cfg, cfg.d_model, dev)
    for layer in p.layers:
        layer.pre_norm = C.init_norm(cfg, cfg.d_model, dev)
        if layer.spec.mixer == "ssd":
            layer.ssd = S.init_ssd(cfg, generator, dev)
        else:
            layer.attn = C.init_attn(cfg, generator, dev)
        if layer.spec.ffn != "none":
            layer.post_norm = C.init_norm(cfg, cfg.d_model, dev)
            if layer.spec.ffn == "moe":
                layer.moe = M.init_moe(cfg, generator, dev)
            else:
                layer.mlp = C.init_mlp(cfg, generator, dev)
    if not cfg.tie_embeddings:
        p.lm_head = C._param((cfg.d_model, cfg.padded_vocab), dev)
        p.lm_head.normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    return p


def cast_params(cfg: ModelConfig, params: LM, dtype: torch.dtype, device=None) -> LM:
    """``params`` on ``device`` (``None``: the card, raising without one)
    with every weight in ``dtype`` and those the reference computes with in
    float32 (:data:`~repro_torch.models.common.FLOAT32_PARAMS`: norm
    scales, router, ``A_log``, ``dt_bias``) kept in float32, in one copy.
    The forward functions cast each weight to the activations' dtype at
    every use, which is then free; the values are those of casting float32
    weights per use."""
    return C.cast_module(params, LM(cfg, device="meta"), dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, layer: Layer, x: torch.Tensor) -> torch.Tensor:
    if layer.spec.ffn == "none":
        return x
    if layer.spec.ffn == "moe":
        return x + M.moe_block(cfg, layer.post_norm.scale, layer.moe, x)
    return x + C.mlp_block(cfg, layer.post_norm.scale, layer.mlp, x)


def _rot(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE angles of ``positions``, shared by every attention layer; None
    for a model without attention (mamba2)."""
    if not cfg.n_heads:
        return None
    return C.rope_angles(positions, cfg.hd, cfg.rope_theta)


def _embed(params: LM, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return PS.hint(params.embed[tokens].to(dtype), "dp", None, None)


def _decode_embed(params: LM, token: torch.Tensor, dtype) -> torch.Tensor:
    """A decode step's residual stream (B, 1, D): its rows over the data
    axes, or, where the batch does not split over them (a batch-1
    long-context decode), its FEATURES, as GSPMD keeps them, so that each
    sublayer contracts its FSDP-split weights where they lie
    (:mod:`~repro_torch.models.tp`).  Then each rank looks the token up in
    its own slice of the table (vocabulary rows over "tp", d_model
    columns over the data axes) and the rows are summed over "tp": no rank
    gathers the table."""
    w = params.embed
    pol = PS.policy() or {}
    if not isinstance(token, DTensor) or any(q.is_shard(0) for q in token.placements):
        return _embed(params, token[:, None], dtype)
    mesh = w.device_mesh
    names = list(mesh.mesh_dim_names)
    dp = pol.get("dp") or ()
    feats = [names.index(a) for a in ((dp,) if isinstance(dp, str) else dp)
             if a in names and mesh.size(names.index(a)) > 1]
    if not feats or w.shape[1] % math.prod(mesh.size(i) for i in feats):
        return _embed(params, token[:, None], dtype)
    tp = names.index(pol["tp"]) if pol.get("tp") in names else None
    if tp is not None and (mesh.size(tp) == 1 or w.shape[0] % mesh.size(tp)):
        tp = None
    v0 = mesh.get_local_rank(tp) * (w.shape[0] // mesh.size(tp)) if tp is not None else 0

    def fn(wl, tl):
        idx = tl[:, None] - v0
        hit = (idx >= 0) & (idx < wl.shape[0])
        return wl[idx.clamp(0, wl.shape[0] - 1)].to(dtype).masked_fill(~hit[..., None], 0)

    def pl(on_tp, on_feats):
        return [on_tp if i == tp else on_feats if i in feats else Replicate()
                for i in range(mesh.ndim)]

    f = local_map(fn, out_placements=pl(Partial(), Shard(2)),
                  in_placements=(pl(Shard(0), Shard(1)), pl(Replicate(), Replicate())),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(w, token).redistribute(mesh, pl(Replicate(), Shard(2)))


def _head(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    w = params.embed if cfg.tie_embeddings else params.lm_head
    logits = C.logits_block(cfg, params.final_norm.scale, w, x, cfg.tie_embeddings)
    return PS.hint(logits, "dp", None, "tp")


def _prefill_layers(cfg: ModelConfig, params: LM, tokens: torch.Tensor, q_chunk: int,
                    dtype) -> Tuple[torch.Tensor, Cache]:
    x = _embed(params, tokens, dtype)
    rot = _rot(cfg, torch.arange(tokens.shape[1], device=tokens.device)[None, :])
    caches = []
    for layer in params.layers:
        scale = layer.pre_norm.scale
        if layer.spec.mixer == "ssd":
            out, lc = S.ssd_block(cfg, scale, layer.ssd, x, return_cache=True)
        else:
            out, lc = C.attn_block(cfg, scale, layer.attn, x, _KIND[layer.spec.mixer], q_chunk,
                                   rot)
        caches.append(lc)
        x = _ffn(cfg, layer, x + out)
    return x, caches


def _apply_layer(cfg: ModelConfig, layer: Layer, x: torch.Tensor, q_chunk: int,
                 rot) -> torch.Tensor:
    # the sequence-parallel residual stream, opt-in by the policy's "sp"
    sp = bool((PS.policy() or {}).get("sp"))
    if sp:
        x = PS.hint(x, "dp", "sp", None)
    scale = layer.pre_norm.scale
    if layer.spec.mixer == "ssd":
        x = x + S.ssd_block(cfg, scale, layer.ssd, x)
    else:
        x = x + C.attn_block(cfg, scale, layer.attn, x, _KIND[layer.spec.mixer], q_chunk, rot)[0]
    if sp and layer.spec.ffn != "none":
        x = PS.hint(x, "dp", "sp", None)
    return _ffn(cfg, layer, x)


def _apply_block(cfg: ModelConfig, block: nn.ModuleList, q_chunk: int, rot,
                 x: torch.Tensor) -> torch.Tensor:
    for layer in block:
        x = _apply_layer(cfg, layer, x, q_chunk, rot)
    return x


def forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor, q_chunk: int = 0,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Causal logits (B, S, V) float32 for tokens (B, S) on the params' device:
    the training forward, differentiable.  The embedding is cast to ``dtype``
    BEFORE the gather, as the reference does: the values equal a gather
    then a cast, but the order sets the dtype in which the gradients of
    repeated tokens add.  With ``cfg.remat`` each block of ``cfg.block`` is
    rematerialised in the backward pass (:func:`~.common.remat_call`); the
    tail is not, as in the reference."""
    x = PS.hint(C.pin_grad(params.embed).to(dtype)[tokens], "dp", None, None)
    rot = _rot(cfg, torch.arange(tokens.shape[1], device=tokens.device)[None, :])
    per = len(cfg.block)
    for j in range(cfg.n_blocks):
        block = params.layers[j * per:(j + 1) * per]
        x = C.remat_call(cfg, functools.partial(_apply_block, cfg, block, q_chunk, rot), x)
    for layer in params.layers[cfg.n_blocks * per:]:
        x = _apply_layer(cfg, layer, x, q_chunk, rot)
    return _head(cfg, params, x)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, tokens: torch.Tensor, q_chunk: int = 0,
            dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """The whole prompt: last-position logits (B, V) and each layer's cache:
    K/V at prompt length, or an SSD layer's final state and conv tail (the
    decode handoff).  An SSD model's prompt length is a multiple of
    ``ssm_chunk``."""
    x, caches = _prefill_layers(cfg, params, tokens, q_chunk, dtype)
    return _head(cfg, params, x[:, -1:, :])[:, 0, :], caches


# ---------------------------------------------------------------------------
# Serving: cache init / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """A zeroed cache per layer on ``device`` (``None``: the card, raising
    without one).  K/V of ``s_max`` positions, or ``min(window, s_max)`` for
    a sliding-window layer, whose cache ``attn_decode`` keeps as a ring
    buffer (it wraps once a position reaches the window); an SSD layer's
    float32 state and conv tail in ``dtype``."""
    dev = resolve_device(device)
    cache = []
    for spec in cfg.layer_specs():
        _check_spec(spec)
        if spec.mixer == "ssd":
            cache.append(S.init_ssd_cache(cfg, batch, dtype, dev))
            continue
        local = spec.mixer == "attn_local" and cfg.window
        length = min(cfg.window, s_max) if local else s_max
        shape = (batch, length, cfg.n_kv_heads, cfg.hd)
        cache.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, token: torch.Tensor, pos: int, cache: Cache,
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """One step: token (B,) at position ``pos`` (an int) -> (B, V) float32
    logits for the NEXT token.  The cache is updated in place and returned."""
    pos = int(pos)
    x = _decode_embed(params, token, dtype)
    rot = _rot(cfg, torch.full((1, 1), pos, device=token.device))
    for layer, lc in zip(params.layers, cache):
        scale = layer.pre_norm.scale
        if layer.spec.mixer == "ssd":
            out = S.ssd_decode_block(cfg, scale, layer.ssd, x, lc)
        else:
            out = C.attn_decode_block(cfg, scale, layer.attn, x, lc, pos, _KIND[layer.spec.mixer],
                                      rot)
        x = _ffn(cfg, layer, x + out)
    return _head(cfg, params, x)[:, 0, :], cache
