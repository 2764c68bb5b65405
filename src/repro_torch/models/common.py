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
    as a ring buffer;
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


def _kv_proj(p, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (a K or V projection); a tensor-parallel rank that holds a
    column slice of w gathers the whole projection (``p.kv_gather``, see
    :func:`_attn_share`)."""
    out = x @ w.to(x.dtype)
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
    q = _split_heads(x @ p.wq.to(dt), b, hd)
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
    if rot is None:
        rot = rope_angles(torch.full((1, 1), pos, device=x.device), cfg.hd, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(cfg, p, x, rot)
    k, v = cache["k"], cache["v"]
    s_max = k.shape[1]
    ring = _ring(cfg, kind, s_max)
    slot = _slot(cfg, kind, pos, s_max)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    kj = torch.arange(s_max, device=x.device)
    if ring:
        # slots [0, min(pos+1, S_max)) hold the last `window` tokens
        mask = kj < min(pos + 1, s_max)
    elif kind == "local" and cfg.window > 0:
        mask = (kj <= pos) & (kj > pos - cfg.window)
    else:
        mask = kj <= pos
    out = _sdpa(q, _pick(p, k), _pick(p, v), mask.reshape(1, s_max))
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
        g = x @ p.wg.to(dt)
        h = g * torch.sigmoid(g) * (x @ p.wi.to(dt))
    else:                   # GELU 2-matrix; jax.nn.gelu's default tanh form
        h = F.gelu(x @ p.wi.to(dt), approximate="tanh")
    return h @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# Sublayers: a pre-norm and its attention or MLP, the residual stream's
# increment.  On a DTensor each runs as one tensor-parallel region
# (:mod:`.tp`): the functions above on each rank's rows and heads or FFN
# columns.
# ---------------------------------------------------------------------------
_ATTN_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "q_scale": None, "k_scale": None}


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
                                  "kv_gather": self.ax if self.kv_gather else None})


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
    in place."""
    if not isinstance(x, DTensor):
        return attn_decode(cfg, p, norm_apply(cfg, x, scale), cache, pos, kind, rot)[0]
    sh = _attn_share(cfg, p, x)
    sw, sd = _norm_weights(cfg, scale)
    slot = _slot(cfg, kind, pos, cache["k"].shape[1])

    def fn(xl, *ws):
        s = ws[0] if sw else None
        kl, vl = ws[-2:]
        out = attn_decode_block(sh.cfg, s, sh.local(ws[len(sw):-2]), xl, {"k": kl, "v": vl},
                                pos, kind, rot)
        return out, kl[:, slot:slot + 1], vl[:, slot:slot + 1]

    kvp = sh.kv(x)
    out, k_new, v_new = TP.region(
        fn, x, sw + sh.weights(p), sd + list(sh.dims), split=sh.split,
        extra=(cache["k"], cache["v"]), extra_placements=(kvp, kvp),
        outs=(TP.partial(x, sh.ax, sh.split), kvp, kvp))
    if tuple(cache["k"].placements) != kvp:     # the region wrote a gathered copy
        _write_slot(cache["k"], slot, k_new)
        _write_slot(cache["v"], slot, v_new)
    return out.redistribute(x.device_mesh, x.placements)


def _write_slot(cache: DTensor, slot: int, new: DTensor) -> None:
    """``cache[:, slot] = new[:, 0]`` on the rank whose shard of a cache
    split over its sequence holds the slot (``new``'s rows and heads are
    the cache's local ones)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, off = compute_local_shape_and_global_offset(cache.shape, cache.device_mesh,
                                                       cache.placements)
    local, row = cache.to_local(), new.to_local()
    if (row.shape[0], *row.shape[2:]) != (local.shape[0], *local.shape[2:]):
        raise ValueError(f"cache shard {tuple(local.shape)} and new rows {tuple(row.shape)}")
    if off[1] <= slot < off[1] + shape[1]:
        local[:, slot - off[1]] = row[:, 0].to(local.dtype)


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
        s = ws[0] if sw else None
        local = SimpleNamespace(**{"wg": None, **dict(zip(names, ws[len(sw):]))})
        return mlp_block(cfg, s, local, xl)

    return TP.region(fn, x, sw + [getattr(p, n) for n in names],
                     sd + [0 if n == "wo" else 1 for n in names], split=split)


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
        h = norm_apply(cfg, xl, ws[0] if sw else None)
        return _logits(cfg, h, ws[-1].T if tied else ws[-1], v0)

    out = TP.rows(x, ax, Shard(x.ndim - 1) if split else None)
    return TP.region(fn, x, sw + [w], sd + [0 if tied else 1], split=split, outs=out)


def _logits(cfg: ModelConfig, h: torch.Tensor, w: torch.Tensor, v0: int) -> torch.Tensor:
    """Logits of vocabulary columns [v0, v0 + w's columns)."""
    logits = (h @ w.to(h.dtype)).float()
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
