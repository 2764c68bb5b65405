"""Shared model components: norms, RoPE, GQA attention, cross-attention,
gated MLP, and the one-time weight cast.

The port of ``repro.models.common``.  The arithmetic is plain functions on
tensors, taking ``(cfg, p, ...)`` as the reference package does; the
weights live in small ``nn.Module``s whose parameter names are the
reference's dict keys (``wq``, ``wk``, ``wv``, ``wo``, ``q_scale``, ``wi``,
``wg``, ``scale``).  Parameters are built without a gradient, as serving
needs them; :func:`trainable` turns it on for training, and
:func:`remat_call` runs a block under the config's rematerialisation.

Weights may be held in float32 and cast per matmul to the activations'
dtype (``w.to(x.dtype)``, the reference's ``.astype(dt)``), or cast once up
front (:func:`cast_module`, behind ``lm.cast_params`` and
``whisper.cast_params``), which gives the same values and makes every
per-matmul cast a no-op.  The weights the reference computes with in
float32 stay float32 (:data:`FLOAT32_PARAMS`): the norm scales, the MoE
router and the SSD's ``A_log`` and ``dt_bias``.

Attention serves four duties from one implementation:
  * full sequence — causal (optionally sliding-window) or bidirectional
    attention, with query chunking so the score matrix never exceeds
    (q_chunk x S) per head;
  * prefill       — the same, returning the prompt's K/V;
  * decode        — one new token against a cache, written in place; a
    sliding-window layer whose cache is no longer than its window keeps it
    as a ring buffer.  The same step over a cache split into runs of
    positions is :func:`partial_decode_attn` on each run, merged by
    :func:`merge_partials` (what each rank of a sequence-split cache
    computes; :func:`attn_decode_chunked` drives it on one device);
  * cross         — the encoder-decoder's decoder queries against the
    encoder's K/V (no RoPE, no mask), computed once per request.

The models call each sublayer — a pre-norm and its attention or MLP, or
the head — through ``attn_block``, ``mlp_block``, ``logits_block`` and
their kin, which run the functions here on plain tensors and, on
DTensors, as one tensor-parallel region (:mod:`.tp`) on each rank's rows
and heads, FFN columns or vocabulary slice.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import tp as TP

__all__ = [
    "rmsnorm",
    "nonparam_ln",
    "norm_apply",
    "norm_local",
    "rope",
    "rope_angles",
    "apply_rope",
    "Norm",
    "Attn",
    "MLP",
    "init_norm",
    "init_attn",
    "init_mlp",
    "attn_forward",
    "attn_prefill",
    "attn_decode",
    "decode_mask",
    "partial_decode_attn",
    "merge_partials",
    "attn_decode_chunked",
    "cross_attn_forward",
    "cross_kv",
    "cross_attn_decode",
    "mlp_forward",
    "attn_block",
    "attn_decode_block",
    "cross_block",
    "cross_kv_block",
    "cross_decode_block",
    "mlp_block",
    "logits_block",
    "init_dense",
    "FLOAT32_PARAMS",
    "cast_module",
    "trainable",
    "rebind",
    "remat_call",
]

NEG_INF = -1e30     # the reference's mask fill, applied to float32 scores
Rot = Tuple[torch.Tensor, torch.Tensor]     # RoPE (cos, sin)


def _param(shape, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), all in float32."""
    return F.rms_norm(x.float(), x.shape[-1:], 1.0 + scale.float(), eps).to(x.dtype)


def nonparam_ln(x: torch.Tensor, _scale=None, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias, in float32.  The
    variance divides by N, as ``jnp.var`` does (``layer_norm``'s, unlike
    ``torch.var``'s default)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def norm_apply(cfg: ModelConfig, x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.norm == "nonparam_ln":
        return nonparam_ln(x)
    return rmsnorm(x, scale)


class Norm(nn.Module):
    """``scale`` (float32, zero-initialised) for RMSNorm; no parameter at
    all for the non-parametric LayerNorm."""

    def __init__(self, cfg: ModelConfig, d: int, device=None) -> None:
        super().__init__()
        if cfg.norm == "nonparam_ln":
            self.register_parameter("scale", None)
        else:
            self.scale = _param((d,), device)


def init_norm(cfg: ModelConfig, d: int, device=None) -> Norm:
    n = Norm(cfg, d, device)
    if n.scale is not None:
        n.scale.zero_()
    return n


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, hd: int, theta: float) -> Rot:
    """(cos, sin), each (..., S, 1, hd/2) float32, of positions (..., S):
    computed once per forward or decode step and shared by every layer."""
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rot: Rot) -> torch.Tensor:
    """Rotate x (..., S, H, hd) by ``rope_angles``: the two concatenated
    halves of the head dimension (not interleaved pairs), in float32."""
    cos, sin = rot
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return apply_rope(x, rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention (GQA; causal / sliding-window / bidirectional; cached decode)
# ---------------------------------------------------------------------------
class Attn(nn.Module):
    """``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd), ``wo`` (H*hd, d), and with
    QK-norm ``q_scale``/``k_scale`` (hd,) — except on a cross-attention,
    which has no QK scales, as in the reference."""

    def __init__(self, cfg: ModelConfig, device=None, cross: bool = False) -> None:
        super().__init__()
        d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, h * hd), device)
        self.wk = _param((d, kv * hd), device)
        self.wv = _param((d, kv * hd), device)
        self.wo = _param((h * hd, d), device)
        if cfg.qk_norm and not cross:
            self.q_scale = _param((hd,), device)
            self.k_scale = _param((hd,), device)
        else:
            self.register_parameter("q_scale", None)
            self.register_parameter("k_scale", None)


def init_attn(cfg: ModelConfig, generator: torch.Generator, device=None,
              cross: bool = False) -> Attn:
    """Standard normal weights scaled by 1/sqrt(d_model) (``wo`` too), QK
    scales at zero: the reference's distributions, drawn from
    ``generator`` (which lies on ``device``)."""
    a = Attn(cfg, device, cross)
    s = 1.0 / math.sqrt(cfg.d_model)
    for w in (a.wq, a.wk, a.wv, a.wo):
        w.normal_(generator=generator).mul_(s)
    if a.q_scale is not None:
        a.q_scale.zero_()
        a.k_scale.zero_()
    return a


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``; a DTensor's gradient is first brought back to ``x``'s
    placements (a redistribution to the same placements), so the view
    before it receives a gradient it can split (DTensor cannot view one
    sharded otherwise unevenly)."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, x.placements)
    return x


def _split_heads(t: torch.Tensor, b: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd)."""
    return t.reshape(b, t.shape[1], -1, hd)


def _dot(p, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a weight whose rows run over d_model; in a region over
    split features (``p.fsplit``, the batch-1 decode layout) the local
    product is summed over the ranks that split them."""
    return TP.feature_sum(x @ w.to(x.dtype), getattr(p, "fsplit", None))


def _kv_proj(p, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (a K or V projection); a tensor-parallel rank that holds a
    column slice of w gathers the whole projection (``p.kv_gather``, see
    :func:`_attn_share`)."""
    out = _dot(p, x, w)
    ax = getattr(p, "kv_gather", None)
    return out if ax is None else TP.all_gather(out, ax)


def _pick(p, t: torch.Tensor) -> torch.Tensor:
    """The K/V heads of ``t`` (B, S, KV, hd) that this rank's query heads
    read, one per query head, where a tensor-parallel rank holds fewer K/V
    heads than a whole one (``p.kv_pick``, see :func:`_attn_region`);
    ``t`` itself otherwise."""
    pick = getattr(p, "kv_pick", None)
    if pick is None:
        return t
    return t.index_select(2, torch.tensor(pick, device=t.device))


def _project_qkv(cfg: ModelConfig, p: Attn, x: torch.Tensor, rot: Optional[Rot],
                 kv_in: Optional[torch.Tensor] = None):
    """Q from ``x``, K/V from ``kv_in`` (default ``x``)."""
    b, hd, dt = x.shape[0], cfg.hd, x.dtype
    kv_in = x if kv_in is None else kv_in
    q = _split_heads(_dot(p, x, p.wq), b, hd)
    k, v = (_split_heads(_kv_proj(p, kv_in, w), b, hd) for w in (p.wk, p.wv))
    if cfg.qk_norm and p.q_scale is not None:
        q = rmsnorm(q, p.q_scale)
        k = rmsnorm(k, p.k_scale)
    if rot is not None:
        q = apply_rope(q, rot)
        k = apply_rope(k, rot)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: (Sq, Sk) bool or None.
    The scores are cast to float32 BEFORE the -1e30 fill (a bf16 fill would
    overflow to -inf and a fully masked row would give NaNs); the softmax
    runs in float32 and its probabilities are cast back."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h * hd)


def _make_mask(sq: int, sk: int, q_off: int, kind: str, window: int,
               device) -> Optional[torch.Tensor]:
    if kind == "bidir":
        return None
    qi = q_off + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = kj <= qi
    if kind == "local" and window > 0:
        mask &= kj > qi - window
    return mask


def _attend(cfg: ModelConfig, q, k, v, kind: str, q_chunk: int) -> torch.Tensor:
    """Full-sequence attention, q-chunked when ``q_chunk`` divides S."""
    b, s = q.shape[:2]
    if q_chunk and s > q_chunk and s % q_chunk == 0:
        outs = [_sdpa(q[:, i:i + q_chunk], k, v,
                      _make_mask(q_chunk, s, i, kind, cfg.window, q.device))
                for i in range(0, s, q_chunk)]
        return torch.cat(outs, dim=1)
    return _sdpa(q, k, v, _make_mask(s, s, 0, kind, cfg.window, q.device))


def attn_forward(cfg: ModelConfig, p: Attn, x: torch.Tensor, kind: str = "causal",
                 q_chunk: int = 0, rot: Optional[Rot] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); ``kind`` is causal | local | bidir."""
    return attn_prefill(cfg, p, x, kind, q_chunk, rot)[0]


def attn_prefill(cfg: ModelConfig, p: Attn, x: torch.Tensor, kind: str, q_chunk: int = 0,
                 rot: Optional[Rot] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward, and the K/V of positions [0, S) (K after RoPE).  ``rot``:
    the angles of positions [0, S), computed here when not given."""
    if kind == "bidir":
        rot = None
    elif rot is None:
        rot = rope_angles(torch.arange(x.shape[1], device=x.device)[None, :], cfg.hd,
                          cfg.rope_theta)
    q, k, v = _project_qkv(cfg, p, x, rot)
    out = _attend(cfg, q, _pick(p, k), _pick(p, v), kind, q_chunk)
    return out @ p.wo.to(x.dtype), {"k": k, "v": v}


def _ring(cfg: ModelConfig, kind: str, s_max: int) -> bool:
    return kind == "local" and cfg.window > 0 and s_max <= cfg.window


def _slot(cfg: ModelConfig, kind: str, pos: int, s_max: int) -> int:
    """The cache slot a decode step at ``pos`` writes."""
    if _ring(cfg, kind, s_max):
        return pos % s_max
    if 0 <= pos < s_max:
        return pos
    raise ValueError(f"decode position {pos} outside the cache of {s_max} positions")


def attn_decode(cfg: ModelConfig, p: Attn, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: int, kind: str = "causal",
                rot: Optional[Rot] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token at position ``pos`` (an int): x (B, 1, D), cache k/v
    (B, S_max, KV, hd), written IN PLACE at ``pos`` — or at ``pos mod
    S_max`` when a sliding-window layer's cache is no longer than its
    window (a ring buffer: K is rotated before it is cached, so the order of
    the slots does not matter).  ``rot``: the angles of ``pos``, computed
    here when not given."""
    q, k, v, s_max = _decode_write(cfg, p, x, cache, pos, kind, rot)
    mask = decode_mask(cfg, kind, pos, s_max, torch.arange(s_max, device=x.device))
    out = _sdpa(q, _pick(p, k), _pick(p, v), mask.reshape(1, s_max))
    return out @ p.wo.to(x.dtype), cache


def _decode_write(cfg: ModelConfig, p: Attn, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  pos: int, kind: str, rot: Optional[Rot]):
    """The step's queries, its K/V row written into ``cache`` at its slot:
    (q, k, v, S_max)."""
    if rot is None:
        rot = rope_angles(torch.full((1, 1), pos, device=x.device), cfg.hd, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(cfg, p, x, rot)
    k, v = cache["k"], cache["v"]
    s_max = k.shape[1]
    slot = _slot(cfg, kind, pos, s_max)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    return q, k, v, s_max


def decode_mask(cfg: ModelConfig, kind: str, pos: int, s_max: int,
                kj: torch.Tensor) -> torch.Tensor:
    """Which of the cache slots ``kj`` (of ``S_max``) a decode step at
    ``pos`` attends: causal for a global layer; the window for a local
    one; the slots written so far for a ring buffer."""
    if _ring(cfg, kind, s_max):
        # slots [0, min(pos+1, S_max)) hold the last `window` tokens
        return kj < min(pos + 1, s_max)
    if kind == "local" and cfg.window > 0:
        return (kj <= pos) & (kj > pos - cfg.window)
    return kj <= pos


def partial_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A decode step's attention over one run of the cache, unnormalised:
    q (B, 1, H, hd) against k/v (B, S, KV, hd) at the slots where
    ``mask`` (S,) holds.  Float32 ``m`` (B, H), the largest score
    (``NEG_INF`` where no slot is valid), ``l`` (B, H) = sum exp(s - m) and
    ``o`` (B, H, hd) = sum exp(s - m) v, every masked slot's term 0.  The
    scores are cast to float32 before the fill, and exp(s - m) to v's
    dtype for the product with v, as :func:`_sdpa` does."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) / math.sqrt(hd)
    s = s.float().masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", e.to(v.dtype), v).float()
    return m.reshape(b, h), e.sum(dim=-1).reshape(b, h), o.reshape(b, h, hd)


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   groups: Optional[Tuple] = None) -> torch.Tensor:
    """The attention (B, H, hd), float32, of the runs whose
    :func:`partial_decode_attn` gave (m, l, o): M = max m, L = sum l
    exp(m - M), O = sum o exp(m - M), then O / L.  Without ``groups`` the
    partials are stacked on a leading dim and merged here; with them each
    rank passes its own, merged over the process groups ``groups``
    (:func:`~.tp.dim_groups`) of the ranks that hold the other runs."""
    if groups is None:
        mx = m.amax(dim=0)
        w = torch.exp(m - mx)
        big_l, big_o = (l * w).sum(dim=0), (o * w[..., None]).sum(dim=0)
    else:
        mx = TP.max_over(m, groups)
        w = torch.exp(m - mx)
        big_l = TP.sum_over(l * w, groups, partial_out=False)
        big_o = TP.sum_over(o * w[..., None], groups, partial_out=False)
    return big_o / big_l[..., None]


def attn_decode_chunked(cfg: ModelConfig, p: Attn, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor], pos: int, kind: str = "causal",
                        rot: Optional[Rot] = None,
                        n_chunks: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`attn_decode` with the cache read as ``n_chunks`` contiguous
    runs of positions (at most S_max), each through
    :func:`partial_decode_attn`, merged by :func:`merge_partials`: the
    sequence-split decode of a mesh, on one device."""
    q, k, v, s_max = _decode_write(cfg, p, x, cache, pos, kind, rot)
    mask = decode_mask(cfg, kind, pos, s_max, torch.arange(s_max, device=x.device))
    n = min(n_chunks, s_max)
    bounds = [(i * s_max // n, (i + 1) * s_max // n) for i in range(n)]
    parts = [partial_decode_attn(q, k[:, a:b], v[:, a:b], mask[a:b]) for a, b in bounds]
    out = merge_partials(*(torch.stack(t) for t in zip(*parts)))
    out = out.reshape(x.shape[0], 1, -1).to(x.dtype)
    return out @ p.wo.to(x.dtype), cache


# ---------------------------------------------------------------------------
# Cross-attention (the encoder-decoder's decoder): K/V from the encoder,
# computed once per request; no RoPE, no mask
# ---------------------------------------------------------------------------
def cross_attn_forward(cfg: ModelConfig, p: Attn, x: torch.Tensor,
                       enc: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends to every position of enc (B, S_enc, D)."""
    q, k, v = _project_qkv(cfg, p, x, None, enc)
    return _sdpa(q, _pick(p, k), _pick(p, v), None) @ p.wo.to(x.dtype)


def cross_kv(cfg: ModelConfig, p: Attn, enc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The cross K/V of enc (B, S_enc, D): ``ck``/``cv`` (B, S_enc, KV, hd)."""
    b, hd = enc.shape[0], cfg.hd
    return {"ck": _split_heads(_kv_proj(p, enc, p.wk), b, hd),
            "cv": _split_heads(_kv_proj(p, enc, p.wv), b, hd)}


def cross_attn_decode(cfg: ModelConfig, p: Attn, x: torch.Tensor,
                      ckv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (B, S, D) against precomputed ``cross_kv`` (cast to x's dtype)."""
    dt = x.dtype
    q = _split_heads(x @ p.wq.to(dt), x.shape[0], cfg.hd)
    k, v = _pick(p, ckv["ck"].to(dt)), _pick(p, ckv["cv"].to(dt))
    return _sdpa(q, k, v, None) @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """``wi`` (d, f), ``wo`` (f, d) and, gated (SwiGLU), ``wg`` (d, f)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = _param((d, f), device)
        self.wo = _param((f, d), device)
        if cfg.gated_mlp:
            self.wg = _param((d, f), device)
        else:
            self.register_parameter("wg", None)


def init_mlp(cfg: ModelConfig, generator: torch.Generator, device=None) -> MLP:
    """Standard normal weights scaled by 1/sqrt(fan-in)."""
    m = MLP(cfg, device)
    for w, fan_in in ((m.wi, cfg.d_model), (m.wg, cfg.d_model), (m.wo, cfg.d_ff)):
        if w is not None:
            w.normal_(generator=generator).div_(math.sqrt(fan_in))
    return m


def mlp_forward(p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if p.wg is not None:    # SwiGLU; silu as x * sigmoid(x), as jax.nn.silu
        g = _dot(p, x, p.wg)
        h = g * torch.sigmoid(g) * _dot(p, x, p.wi)
    else:                   # GELU 2-matrix; jax.nn.gelu's default tanh form
        h = F.gelu(_dot(p, x, p.wi), approximate="tanh")
    return h @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# Sublayers: a pre-norm and its attention or MLP, the residual stream's
# increment.  On a DTensor each runs as one tensor-parallel region
# (:mod:`.tp`): the functions above on each rank's rows and heads or FFN
# columns.
# ---------------------------------------------------------------------------
_ATTN_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "q_scale": None, "k_scale": None}
# the dim of each weight that runs over d_model (split where x's features are)
_ATTN_MODEL_DIMS = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "q_scale": None, "k_scale": None}


@dataclasses.dataclass(frozen=True)
class _AttnShare:
    """This rank's share of an attention: its config (head counts), the
    weights passed to the region with the dim each splits on, the K/V heads
    its query heads read when it holds fewer than one K/V head
    (:func:`_pick`), whether it then projects a column slice of every K/V
    head and gathers them (:func:`_kv_proj`), and the placements of the
    region's K/V tensors."""

    ax: TP.Axes
    split: bool
    cfg: ModelConfig
    names: Tuple[str, ...]
    dims: Tuple[Optional[int], ...]
    pick: Optional[Tuple[int, ...]]
    kv_split: bool
    kv_gather: bool

    def kv(self, x: DTensor) -> Tuple:
        """K/V (B, S, KV, hd): rows as x's, heads split iff they split."""
        return TP.rows(x, self.ax, Shard(2) if self.kv_split else None)

    @property
    def model_dims(self) -> Tuple[Optional[int], ...]:
        return tuple(_ATTN_MODEL_DIMS[n] for n in self.names)

    def keep(self, names: Tuple[str, ...]) -> "_AttnShare":
        """The share of the weights ``names`` alone (a step that reads no
        others)."""
        kept = tuple(n for n in self.names if n in names)
        return dataclasses.replace(self, names=kept,
                                   dims=tuple(self.dims[self.names.index(n)] for n in kept))

    def weights(self, p: Attn):
        return [getattr(p, n) for n in self.names]

    def local(self, ws) -> SimpleNamespace:
        return SimpleNamespace(**{**dict.fromkeys(_ATTN_DIMS), **dict(zip(self.names, ws)),
                                  "kv_pick": self.pick,
                                  "kv_gather": self.ax if self.kv_gather else None,
                                  "fsplit": self.ax if self.ax.features else None})


def _attn_share(cfg: ModelConfig, p: Attn, x: DTensor) -> _AttnShare:
    """Query heads split over "tp" where they divide; K/V heads where they
    divide too, else each rank projects its columns of every K/V head (the
    whole of them where the columns do not divide either), gathers them and
    reads those of its query heads."""
    ax = TP.axes(x)
    split = ax.tp is not None and cfg.n_heads % ax.n == 0
    kv_split = split and cfg.n_kv_heads % ax.n == 0
    kv_gather = split and not kv_split and cfg.n_kv_heads * cfg.hd % ax.n == 0
    names = tuple(n for n in _ATTN_DIMS if getattr(p, n) is not None)
    dims = tuple(_ATTN_DIMS[n] if (n in ("wq", "wo") or kv_split or kv_gather) else None
                 for n in names)
    local, pick = cfg, None
    if split:
        h = cfg.n_heads // ax.n
        local = dataclasses.replace(cfg, n_heads=h, head_dim=cfg.hd, n_kv_heads=(
            cfg.n_kv_heads // ax.n if kv_split else cfg.n_kv_heads))
        if not kv_split:
            g = cfg.n_heads // cfg.n_kv_heads
            pick = tuple((ax.rank * h + i) // g for i in range(h))
    return _AttnShare(ax, split, local, names, dims, pick, kv_split, kv_gather)


def _norm_weights(cfg: ModelConfig, scale: Optional[torch.Tensor]):
    return ([scale], [None]) if cfg.norm != "nonparam_ln" else ([], [])


def _norm_model_dims(cfg: ModelConfig):
    return [0] if cfg.norm != "nonparam_ln" else []


def norm_local(cfg: ModelConfig, x: torch.Tensor, scale: Optional[torch.Tensor],
               ax: TP.Axes) -> torch.Tensor:
    """:func:`norm_apply` of a region's local x; where its features are
    split (``ax.features``) the statistics are summed over their ranks
    (float32, the mean first, then the centred squares for a LayerNorm)."""
    if not ax.features:
        return norm_apply(cfg, x, scale)
    xf = x.float()
    d = x.shape[-1] * ax.fn
    if cfg.norm == "nonparam_ln":
        xf = xf - TP.feature_sum(xf.sum(-1, keepdim=True), ax) / d
        var = TP.feature_sum(xf.square().sum(-1, keepdim=True), ax) / d
        return (xf * torch.rsqrt(var + 1e-5)).to(x.dtype)
    ms = TP.feature_sum(xf.square().sum(-1, keepdim=True), ax) / d
    return (xf * torch.rsqrt(ms + 1e-6) * (1.0 + scale.float())).to(x.dtype)


def attn_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: Attn, x: torch.Tensor,
               kind: str, q_chunk: int = 0, rot: Optional[Rot] = None):
    """``attn_prefill`` of the normed x: (increment, {"k", "v"})."""
    if not isinstance(x, DTensor):
        return attn_prefill(cfg, p, norm_apply(cfg, x, scale), kind, q_chunk, rot)
    sh = _attn_share(cfg, p, x)
    sw, sd = _norm_weights(cfg, scale)

    def fn(xl, *ws):
        s = ws[0] if sw else None
        out, kv = attn_block(sh.cfg, s, sh.local(ws[len(sw):]), xl, kind, q_chunk, rot)
        return out, kv["k"], kv["v"]

    kvp = sh.kv(x)
    out, k, v = TP.region(fn, x, sw + sh.weights(p), sd + list(sh.dims),
                          split=sh.split, outs=(TP.partial(x, sh.ax, sh.split), kvp, kvp))
    return out.redistribute(x.device_mesh, x.placements), {"k": k, "v": v}


def attn_decode_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: Attn,
                      x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
                      kind: str = "causal", rot: Optional[Rot] = None) -> torch.Tensor:
    """``attn_decode`` of the normed x: the increment; ``cache`` is written
    in place.  On DTensors each rank reads its shard of the cache where it
    lies: its rows and heads (:func:`_decode_heads`) or, where the cache's
    sequence is split, its run of positions (:func:`_decode_runs`); a
    cache placed otherwise raises."""
    if not isinstance(x, DTensor):
        return attn_decode(cfg, p, norm_apply(cfg, x, scale), cache, pos, kind, rot)[0]
    sh = _attn_share(cfg, p, x)
    placed = tuple(cache["k"].placements), tuple(cache["v"].placements)
    if placed == (sh.kv(x),) * 2:
        return _decode_heads(cfg, scale, p, x, cache, pos, kind, rot, sh)
    seq = tuple(i for i, q in enumerate(placed[0]) if q.is_shard(1))
    want = tuple(Shard(1) if i in seq else q for i, q in enumerate(TP.rows(x, sh.ax)))
    if not seq or placed != (want,) * 2:
        raise ValueError(f"decode cache placed {placed[0]}, {placed[1]}: neither as the "
                         f"step's heads ({sh.kv(x)}) nor split over its sequence ({want})")
    return _decode_runs(cfg, scale, p, x, cache, pos, kind, rot, sh, seq)


def _decode_heads(cfg: ModelConfig, scale, p: Attn, x: DTensor, cache, pos: int, kind: str,
                  rot: Optional[Rot], sh: _AttnShare) -> DTensor:
    """The decode region over a cache split as the step's rows and heads:
    each rank attends its heads over every position of its rows."""
    sw, sd = _norm_weights(cfg, scale)

    def fn(xl, *ws):
        h = norm_local(cfg, xl, ws[0] if sw else None, sh.ax)
        kl, vl = ws[-2:]
        return attn_decode(sh.cfg, sh.local(ws[len(sw):-2]), h, {"k": kl, "v": vl}, pos,
                           kind, rot)[0]

    kvp = sh.kv(x)
    return TP.region(fn, x, sw + sh.weights(p), sd + list(sh.dims), split=sh.split,
                     model_dims=_norm_model_dims(cfg) + list(sh.model_dims),
                     extra=(cache["k"], cache["v"]), extra_placements=(kvp, kvp))


def _decode_runs(cfg: ModelConfig, scale, p: Attn, x: DTensor, cache, pos: int, kind: str,
                 rot: Optional[Rot], sh: _AttnShare, seq: Tuple[int, ...]) -> DTensor:
    """The decode region over a cache whose sequence is split over the
    mesh dims ``seq`` (over ("data", "model") jointly for a batch-1 long
    context, over "model" where the K/V heads do not divide it): each rank
    (a) writes the new K/V row if its run holds the slot, (b) attends every
    head's query (gathered over "tp", a few KB) over its own positions
    (:func:`partial_decode_attn`), (c) merges the partials over ``seq``
    (:func:`merge_partials`) and (d) applies ``wo`` on its heads."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    sw, sd = _norm_weights(cfg, scale)
    k = cache["k"]
    s_max = k.shape[1]
    shape, off = compute_local_shape_and_global_offset(k.shape, k.device_mesh, k.placements)
    start, n = off[1], shape[1]
    slot = _slot(cfg, kind, pos, s_max)
    groups = TP.dim_groups(k.device_mesh, seq)
    ax, hl, hd = sh.ax, sh.cfg.n_heads, cfg.hd

    def fn(xl, *ws):
        h = norm_local(cfg, xl, ws[0] if sw else None, ax)
        kl, vl = ws[-2:]
        local = sh.local(ws[len(sw):-2])
        r = rot if rot is not None else rope_angles(
            torch.full((1, 1), pos, device=xl.device), hd, cfg.rope_theta)
        q, k_new, v_new = _project_qkv(sh.cfg, local, h, r)
        b = q.shape[0]
        if sh.split:        # every head's query; every K/V head's new row
            q = TP.all_gather(q.reshape(b, 1, hl * hd), ax).reshape(b, 1, -1, hd)
        if sh.kv_split:
            k_new, v_new = (TP.all_gather(t.reshape(b, 1, -1), ax).reshape(b, 1, -1, hd)
                            for t in (k_new, v_new))
        if start <= slot < start + n:
            kl[:, slot - start] = k_new[:, 0].to(kl.dtype)
            vl[:, slot - start] = v_new[:, 0].to(vl.dtype)
        mask = decode_mask(cfg, kind, pos, s_max, torch.arange(start, start + n,
                                                              device=xl.device))
        out = merge_partials(*partial_decode_attn(q, kl, vl, mask), groups)
        if sh.split:
            out = out[:, ax.rank * hl:(ax.rank + 1) * hl]
        out = out.reshape(b, 1, hl * hd).to(xl.dtype)
        return out @ local.wo.to(xl.dtype)

    return TP.region(fn, x, sw + sh.weights(p), sd + list(sh.dims), split=sh.split,
                     model_dims=_norm_model_dims(cfg) + list(sh.model_dims),
                     extra=(cache["k"], cache["v"]),
                     extra_placements=(k.placements, cache["v"].placements))


def cross_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: Attn, x: torch.Tensor,
                enc: torch.Tensor) -> torch.Tensor:
    """``cross_attn_forward`` of the normed x against enc: the increment."""
    if not isinstance(x, DTensor):
        return cross_attn_forward(cfg, p, norm_apply(cfg, x, scale), enc)
    sh = _attn_share(cfg, p, x)
    sw, sd = _norm_weights(cfg, scale)

    def fn(xl, *ws):
        s = ws[0] if sw else None
        return cross_block(sh.cfg, s, sh.local(ws[len(sw):-1]), xl, ws[-1])

    return TP.region(fn, x, sw + sh.weights(p), sd + list(sh.dims),
                     split=sh.split, extra=(enc,), extra_placements=(TP.rows(x, sh.ax),),
                     extra_grads=(TP.partial(x, sh.ax, sh.split),))


def cross_kv_block(cfg: ModelConfig, p: Attn, enc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``cross_kv``; a DTensor enc gives each rank its K/V heads."""
    if not isinstance(enc, DTensor):
        return cross_kv(cfg, p, enc)
    sh = _attn_share(cfg, p, enc).keep(("wk", "wv"))

    def fn(el, *ws):
        kv = cross_kv(sh.cfg, sh.local(ws), el)
        return kv["ck"], kv["cv"]

    kvp = sh.kv(enc)
    ck, cv = TP.region(fn, enc, sh.weights(p), sh.dims, split=sh.split, outs=(kvp, kvp))
    return {"ck": ck, "cv": cv}


def cross_decode_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: Attn,
                       x: torch.Tensor, ckv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``cross_attn_decode`` of the normed x against cached cross K/V."""
    if not isinstance(x, DTensor):
        return cross_attn_decode(cfg, p, norm_apply(cfg, x, scale), ckv)
    # the K/V projections are in the cache: the step reads the rest only
    sh = _attn_share(cfg, p, x).keep(("wq", "wo", "q_scale"))
    sw, sd = _norm_weights(cfg, scale)

    def fn(xl, *ws):
        s = ws[0] if sw else None
        return cross_decode_block(sh.cfg, s, sh.local(ws[len(sw):-2]), xl,
                                  {"ck": ws[-2], "cv": ws[-1]})

    kvp = sh.kv(x)
    return TP.region(fn, x, sw + sh.weights(p), sd + list(sh.dims), split=sh.split,
                     extra=(ckv["ck"], ckv["cv"]), extra_placements=(kvp, kvp))


def mlp_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: MLP,
              x: torch.Tensor) -> torch.Tensor:
    """``mlp_forward`` of the normed x: the increment, FFN columns split
    over "tp" where they divide."""
    if not isinstance(x, DTensor):
        return mlp_forward(p, norm_apply(cfg, x, scale))
    ax = TP.axes(x)
    split = ax.tp is not None and cfg.d_ff % ax.n == 0
    sw, sd = _norm_weights(cfg, scale)
    names = [n for n in ("wi", "wg", "wo") if getattr(p, n) is not None]

    def fn(xl, *ws):
        h = norm_local(cfg, xl, ws[0] if sw else None, ax)
        local = SimpleNamespace(**{"wg": None, **dict(zip(names, ws[len(sw):])),
                                   "fsplit": ax})
        return mlp_forward(local, h)

    return TP.region(fn, x, sw + [getattr(p, n) for n in names],
                     sd + [0 if n == "wo" else 1 for n in names], split=split,
                     model_dims=_norm_model_dims(cfg) + [1 if n == "wo" else 0 for n in names])


def logits_block(cfg: ModelConfig, scale: Optional[torch.Tensor], w: torch.Tensor,
                 x: torch.Tensor, tied: bool) -> torch.Tensor:
    """The head: float32 logits (..., padded V) of the normed x against
    ``w`` (D, V), or the embedding (V, D) when ``tied``; the padding
    columns are ``NEG_INF`` (they never win, and get no gradient).  On a
    DTensor each rank computes its slice of the vocabulary, split over
    "tp" where it divides."""
    if not isinstance(x, DTensor):
        return _logits(cfg, norm_apply(cfg, x, scale), w.T if tied else w, 0)
    ax = TP.axes(x)
    split = ax.tp is not None and cfg.padded_vocab % ax.n == 0
    v0 = ax.rank * (cfg.padded_vocab // ax.n) if split else 0
    sw, sd = _norm_weights(cfg, scale)

    def fn(xl, *ws):
        h = norm_local(cfg, xl, ws[0] if sw else None, ax)
        return _logits(cfg, h, ws[-1].T if tied else ws[-1], v0, ax)

    out = TP.rows(x, ax, Shard(x.ndim - 1) if split else None)
    return TP.region(fn, x, sw + [w], sd + [0 if tied else 1], split=split, outs=out,
                     model_dims=_norm_model_dims(cfg) + [1 if tied else 0])


def _logits(cfg: ModelConfig, h: torch.Tensor, w: torch.Tensor, v0: int,
            ax: Optional[TP.Axes] = None) -> torch.Tensor:
    """Logits of vocabulary columns [v0, v0 + w's columns); ``ax``: a
    region's axes, whose split features the product is summed over."""
    logits = TP.feature_sum(h @ w.to(h.dtype), ax).float()
    pad = max(cfg.vocab - v0, 0)
    if pad < logits.shape[-1]:
        logits[..., pad:] = NEG_INF
    return logits


# ---------------------------------------------------------------------------
# The one-time cast
# ---------------------------------------------------------------------------
# Parameters whose names end so are computed with in float32 by the
# reference (norm scales; the MoE router, ``x.astype(float32) @ router``;
# the SSD's ``-exp(A_log)`` and ``softplus(dt + dt_bias)``): a cast to bf16
# would round them, and the router's top-k would then differ.
FLOAT32_PARAMS = ("scale", "router", "A_log", "dt_bias")


def cast_module(params: nn.Module, out: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """Load ``params``' values into ``out`` (the same layout, built on the
    meta device) on ``device`` with every weight in ``dtype`` and the
    :data:`FLOAT32_PARAMS` in float32, in one copy (none where a tensor is
    already so)."""
    state = {}
    for name, t in params.state_dict().items():
        keep = name.endswith(FLOAT32_PARAMS)
        state[name] = t.to(device=device, dtype=torch.float32 if keep else dtype)
    out.load_state_dict(state, assign=True)
    return out


def init_dense(generator: torch.Generator, shape: Tuple[int, ...], scale: float,
               device=None) -> torch.Tensor:
    """A float32 tensor of ``shape`` on ``device`` (``None``: the card,
    raising without one): standard normal draws from ``generator`` times
    ``scale``, the reference's ``normal(key, shape) * scale`` (the values
    are torch's draws, not ``jax.random``'s)."""
    out = torch.empty(shape, dtype=torch.float32, device=resolve_device(device))
    return out.normal_(generator=generator).mul_(scale)


# ---------------------------------------------------------------------------
# Training: gradients and rematerialisation
# ---------------------------------------------------------------------------
def trainable(params: nn.Module) -> nn.Module:
    """Turn on ``requires_grad`` for every parameter of ``params`` (in
    place) and return it.  Serving keeps them off."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def rebind(like: nn.Module, named: Mapping[str, torch.Tensor]) -> nn.Module:
    """A module laid out as ``like`` (the same classes, layer specs and
    parameter names) whose parameters are the tensors of ``named``, keyed by
    ``like``'s parameter names, each requiring a gradient iff ``like``'s
    does.  ``like`` is left as it was; no tensor is copied."""
    def clone(m: nn.Module, prefix: str) -> nn.Module:
        new = copy.copy(m)      # shares every attribute; the two dicts below are replaced
        new._parameters = {
            k: None if p is None else nn.Parameter(named[prefix + k], requires_grad=p.requires_grad)
            for k, p in m._parameters.items()}
        new._modules = {k: clone(c, f"{prefix}{k}.") for k, c in m._modules.items()}
        return new
    return clone(like, "")


# the weight products of a layer: 2-D matmuls with no batch dimension (a
# (B, S, D) @ (D, F) product reaches aten as one mm), which is what the
# reference's ``dots_with_no_batch_dims_saveable`` keeps; the attention
# and expert products are batched (bmm) and recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(cfg: ModelConfig, fn: Callable, x: torch.Tensor, policy: Optional[str] = None):
    """``fn(x)``, rematerialised in the backward pass as the reference's
    ``jax.checkpoint`` of a block is when ``cfg.remat`` is set: policy
    ``"nothing"`` saves only ``x``, ``"dots"`` also the weight products.
    ``policy`` overrides ``cfg.remat_policy``.  Without a gradient to take
    (``torch.no_grad``) it is a plain call."""
    if not cfg.remat or not torch.is_grad_enabled():
        return fn(x)
    policy = policy or cfg.remat_policy
    if policy == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return ckpt.checkpoint(fn, x, use_reentrant=False, context_fn=ctx)
    if policy != "nothing":
        raise ValueError(f"unknown remat policy {policy!r}")
    return ckpt.checkpoint(fn, x, use_reentrant=False)
