"""Mamba2 block: short causal conv + SSD (state-space duality) mixer.

The port of ``repro.models.ssd``.  The full-sequence path is the CHUNKED
dual form (arXiv:2405.21060 §6): within-chunk terms are attention-like
einsums, across-chunk terms a recurrence over per-chunk states, run here
as a loop over the chunks (the reference's ``lax.scan``).  Decode is the
recurrent form: a constant-size (B, H, P, N) float32 state and a
(B, k-1, conv_dim) tail of the raw (pre-conv) projections, both updated in
place.

The casts follow the reference's step by step: the projections, the
within-chunk mask ``L``, ``decay_in`` and ``xs * dt`` are in the
activations' dtype; ``dt``, ``A`` and the segment sums in float32; the
decode state in float32, its output cast back before ``+ xs * D``.

Shapes: D=d_model, d_inner=expand*D, P=ssm_head_dim, H=d_inner/P heads,
N=ssm_state, G=1 B/C group.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import tp as TP

__all__ = ["SSD", "init_ssd", "ssd_forward", "ssd_decode", "init_ssd_cache", "ssd_block",
           "ssd_decode_block"]

SSDCache = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    p_ = cfg.ssm_head_dim
    return cfg.d_model, di, p_, di // p_, cfg.ssm_state


class SSD(nn.Module):
    """``in_proj`` (d, 2*di + 2*N + H) -> [z, x, B, C, dt]; the depthwise
    conv ``conv_w`` (k, conv_dim) and ``conv_b``; per head ``A_log``, ``D``
    and ``dt_bias``; the gated norm's ``norm_scale`` (di,); ``out_proj``
    (di, d)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        d, di, _, h, n = _dims(cfg)
        conv_dim = di + 2 * n
        self.in_proj = C._param((d, 2 * di + 2 * n + h), device)
        self.conv_w = C._param((cfg.ssm_conv, conv_dim), device)
        self.conv_b = C._param((conv_dim,), device)
        self.A_log = C._param((h,), device)
        self.D = C._param((h,), device)
        self.dt_bias = C._param((h,), device)
        self.norm_scale = C._param((di,), device)
        self.out_proj = C._param((di, d), device)


def init_ssd(cfg: ModelConfig, generator: torch.Generator, device=None) -> SSD:
    """The reference's distributions: normal projections over sqrt(fan-in),
    a normal conv times 0.1, ``A_log`` 0 (A = -1), ``D`` 1, the biases and
    ``norm_scale`` 0."""
    p = SSD(cfg, device)
    p.in_proj.normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    p.conv_w.normal_(generator=generator).mul_(0.1)
    p.out_proj.normal_(generator=generator).div_(math.sqrt(cfg.d_inner))
    for z in (p.conv_b, p.A_log, p.dt_bias, p.norm_scale):
        z.zero_()
    p.D.fill_(1.0)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _split_proj(di: int, n: int, proj: torch.Tensor):
    """[z, x, B, C, dt] of a projection as (z, xBC, dt)."""
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel (k, C), x (B, S, C), then SiLU."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return _silu(out + b)


def _gated_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                ax: Optional[TP.Axes] = None) -> torch.Tensor:
    """RMS norm (float32, 1 + scale) of x * silu(z), the gate applied in
    x's dtype.  With ``ax``, x holds this tensor-parallel rank's channels
    and the mean square is taken over every rank's."""
    g = x * _silu(z)
    if ax is None or ax.tp is None:
        return C.rmsnorm(g, scale)
    gf = g.float()
    ms = TP.all_reduce(gf.pow(2).sum(-1, keepdim=True), ax) / (gf.shape[-1] * ax.n)
    return (gf * torch.rsqrt(ms + 1e-6) * (1.0 + scale.float())).to(g.dtype)


def _dt_a(p: SSD, dt: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(A_log), both float32."""
    return F.softplus(dt.float() + p.dt_bias.float()), -torch.exp(p.A_log.float())


def ssd_forward(cfg: ModelConfig, p: SSD, x: torch.Tensor, return_cache: bool = False):
    """Chunked SSD over x (B, S, D) -> (B, S, D); S must be a multiple of
    ``ssm_chunk``.  ``return_cache=True`` also returns the decode handoff:
    the final state (float32) and the last k-1 raw projections."""
    out, carry, xbc_raw = _mix(cfg, _dims(cfg)[1:], p, x @ p.in_proj.to(x.dtype))
    if return_cache:
        return out, {"state": carry.float(),
                     "conv": xbc_raw[:, x.shape[1] - (cfg.ssm_conv - 1):, :].clone()}
    return out


def _mix(cfg: ModelConfig, dims, p, proj: torch.Tensor, ax: Optional[TP.Axes] = None):
    """The chunked SSD of a projection (B, S, [z, x, B, C, dt]) with
    ``dims`` = (d_inner, P, H, N): (output, final state, raw xBC).  ``ax``:
    the tensor-parallel axis whose ranks share the channels (the gated
    norm's mean)."""
    di, p_, h, n = dims
    b, s, _ = proj.shape
    q = cfg.ssm_chunk
    if s % q:
        raise AssertionError((s, q))
    c = s // q
    dt_ = proj.dtype

    z, xbc_raw, dt = _split_proj(di, n, proj)
    xbc = _causal_conv(p.conv_w.to(dt_), p.conv_b.to(dt_), xbc_raw)
    xs = xbc[..., :di].reshape(b, c, q, h, p_)
    Bm = xbc[..., di:di + n].reshape(b, c, q, n)
    Cm = xbc[..., di + n:].reshape(b, c, q, n)
    dt, A = _dt_a(p, dt)                                         # (B,S,H), (H,)
    dt = dt.reshape(b, c, q, h)
    dA_cs = torch.cumsum(dt * A, dim=2)                          # (B,C,Q,H)
    # within-chunk: L[l, s'] = exp(dA_cs[l] - dA_cs[s']) for s' <= l.  Above
    # the diagonal the exponent is positive and may overflow to inf, so it
    # is masked to -inf BEFORE the exp: the values equal the reference's
    # where(tril, exp(seg), 0) bit for bit, and the gradient stays finite
    # where the reference's is 0 * inf = NaN
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]      # (B,C,Q,Q,H)
    tril = torch.ones(q, q, dtype=torch.bool, device=proj.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], seg, float("-inf"))).to(dt_)
    xdt = xs * dt[..., None].to(dt_)                             # (B,C,Q,H,P)
    cb = torch.einsum("bcln,bcsn->bcls", Cm, Bm)                 # (B,C,Q,Q)
    y = torch.einsum("bclsh,bcshp->bclhp", cb[..., None] * L, xdt)

    # per-chunk states, then the recurrence across chunks: chunk i reads the
    # state left by chunks < i
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs).to(dt_)   # (B,C,Q,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bm, xdt * decay_out[..., None])
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # (B,C,H)
    carry = torch.zeros((b, h, p_, n), dtype=dt_, device=proj.device)
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None].to(dt_) + states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # (B,C,H,P,N)

    decay_in = torch.exp(dA_cs).to(dt_)                          # (B,C,Q,H)
    y = y + torch.einsum("bcln,bchpn->bclhp", Cm, prev_states) * decay_in[..., None]
    y = y + xs * p.D.to(dt_)[:, None]
    y = _gated_norm(y.reshape(b, s, di), z, p.norm_scale, ax)
    return y @ p.out_proj.to(dt_), carry, xbc_raw


# ---------------------------------------------------------------------------
# Recurrent decode
# ---------------------------------------------------------------------------
def init_ssd_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> SSDCache:
    """A zero float32 state (B, H, P, N) and conv tail (B, k-1, conv_dim) in
    ``dtype``, on ``device``."""
    _, di, p_, h, n = _dims(cfg)
    return {"state": torch.zeros((batch, h, p_, n), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype,
                                device=device)}


def ssd_decode(cfg: ModelConfig, p: SSD, x: torch.Tensor,
               cache: SSDCache) -> Tuple[torch.Tensor, SSDCache]:
    """One token, x (B, 1, D) -> (B, 1, D); ``cache`` is updated in place
    and returned."""
    _, di, p_, h, n = _dims(cfg)
    proj = x[:, 0, :] @ p.in_proj.to(x.dtype)
    win = torch.cat([cache["conv"], _split_proj(di, n, proj)[1][:, None, :]], dim=1)
    cache["conv"].copy_(win[:, 1:, :])
    xbc = _conv_step(win, p.conv_w, p.conv_b)
    return _decode_mix((di, p_, h, n), p, proj, xbc, cache["state"])[:, None, :], cache


def _conv_step(win: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The depthwise conv of the window ``win`` (B, k, C) of raw xBC
    channels, then SiLU: (B, C).  A channel reads only its own column, so
    any run of channels convolves alone."""
    dt_ = win.dtype
    return _silu(torch.einsum("bkc,kc->bc", win, w.to(dt_)) + b.to(dt_))


def _decode_mix(dims, p, proj: torch.Tensor, xbc: torch.Tensor, st: torch.Tensor,
                ax: Optional[TP.Axes] = None) -> torch.Tensor:
    """One recurrent step of a projection (B, [z, x, B, C, dt]) with the
    convolved xBC ``xbc`` (B, xBC), the float32 state ``st`` (B, H, P, N)
    updated in place: the output (B, D)."""
    di, p_, h, n = dims
    b = proj.shape[0]
    dt_ = proj.dtype
    z, _, dt = _split_proj(di, n, proj)

    xs = xbc[:, :di].reshape(b, h, p_)
    Bm = xbc[:, di:di + n].float()
    Cm = xbc[:, di + n:].float()
    dtv, A = _dt_a(p, dt)                                        # (B,H), (H,)
    # state * decay + (x * dt) outer B, in place: addcmul_ writes in the
    # state's own layout (a broadcast outer product comes out permuted, and
    # adding it took a strided pass four times slower on the card)
    st.mul_(torch.exp(dtv * A)[:, :, None, None])
    st.addcmul_((xs.float() * dtv[..., None])[..., None], Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", st, Cm).to(dt_)
    y = y + xs * p.D.to(dt_)[:, None]
    y = _gated_norm(y.reshape(b, di), z, p.norm_scale, ax)
    return y @ p.out_proj.to(dt_)


# ---------------------------------------------------------------------------
# The sublayer: the pre-norm and the SSD, plain or in a tensor-parallel
# region (:mod:`.tp`) whose ranks split the heads (and with them z, x, dt,
# the gated norm's channels and out_proj's rows) where they divide: each
# rank projects its columns of in_proj and gathers the projection, whose
# B and C every head reads
# ---------------------------------------------------------------------------
_NAMES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj")
# the dim of each that runs over d_model (split where x's features are)
_MODEL_DIMS = [0, None, None, None, None, None, None, 1]


def _share(cfg: ModelConfig, x: DTensor):
    """(axes, heads split, in_proj's columns split) over "tp"."""
    ax = TP.axes(x)
    _, di, _, h, n = _dims(cfg)
    split = ax.tp is not None and h % ax.n == 0
    return ax, split, split and (2 * di + 2 * n + h) % ax.n == 0


def _rank_slices(cfg: ModelConfig, ax: TP.Axes):
    _, di, _, h, _ = _dims(cfg)
    dl, hl = di // ax.n, h // ax.n
    return slice(ax.rank * dl, (ax.rank + 1) * dl), slice(ax.rank * hl, (ax.rank + 1) * hl)


def _xbc_channels(cfg: ModelConfig, ax: TP.Axes, t: torch.Tensor) -> torch.Tensor:
    """The rank's x channels and all of B and C of t (..., xBC)."""
    di = _dims(cfg)[1]
    ch, _ = _rank_slices(cfg, ax)
    return torch.cat([t[..., ch], t[..., di:]], dim=-1)


def _local(cfg: ModelConfig, ax: TP.Axes, split: bool, ws, proj: torch.Tensor):
    """The rank's dims, weights and projection columns of a full projection."""
    d, di, p_, h, n = _dims(cfg)
    p = SimpleNamespace(**dict(zip(_NAMES, ws)))
    if not split:
        return (di, p_, h, n), p, proj
    ch, hs = _rank_slices(cfg, ax)
    z, xbc, dt = _split_proj(di, n, proj)
    conv = {} if p.conv_w is None else dict(conv_w=_xbc_channels(cfg, ax, p.conv_w),
                                            conv_b=_xbc_channels(cfg, ax, p.conv_b))
    local = SimpleNamespace(
        A_log=p.A_log[hs], D=p.D[hs], dt_bias=p.dt_bias[hs], norm_scale=p.norm_scale[ch],
        out_proj=p.out_proj, **conv)
    proj = torch.cat([z[..., ch], _xbc_channels(cfg, ax, xbc), dt[..., hs]], dim=-1)
    return (di // ax.n, p_, h // ax.n, n), local, proj


def _project(h: torch.Tensor, in_proj: torch.Tensor, ax: TP.Axes, gather: bool):
    proj = TP.feature_sum(h @ in_proj.to(h.dtype), ax)
    return TP.all_gather(proj, ax) if gather else proj


def ssd_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: SSD, x: torch.Tensor,
              return_cache: bool = False):
    """``ssd_forward`` of the normed x: the increment (and the decode
    handoff with ``return_cache``)."""
    if not isinstance(x, DTensor):
        return ssd_forward(cfg, p, C.norm_apply(cfg, x, scale), return_cache)
    ax, split, gather = _share(cfg, x)
    sw, sd = C._norm_weights(cfg, scale)
    _, di, _, _, n = _dims(cfg)
    s, k = x.shape[1], cfg.ssm_conv

    def fn(xl, *ws):
        h = C.norm_apply(cfg, xl, ws[0] if sw else None)
        ws = ws[len(sw):]
        proj = _project(h, ws[0], ax, gather)
        dims, local, lproj = _local(cfg, ax, split, ws, proj)
        out, carry, _ = _mix(cfg, dims, local, lproj, ax if split else None)
        if not return_cache:
            return out
        return out, carry.float(), _split_proj(di, n, proj)[1][:, s - (k - 1):, :].clone()

    dims = sd + [1 if gather else None] + [None] * 6 + [0]
    ws = sw + [getattr(p, name) for name in _NAMES]
    if not return_cache:
        return TP.region(fn, x, ws, dims, split=split)
    out, state, conv = TP.region(
        fn, x, ws, dims, split=split,
        outs=(TP.partial(x, ax, split), TP.rows(x, ax, Shard(1) if split else None),
              TP.rows(x, ax)))
    return out.redistribute(x.device_mesh, x.placements), {"state": state, "conv": conv}


def ssd_decode_block(cfg: ModelConfig, scale: Optional[torch.Tensor], p: SSD,
                     x: torch.Tensor, cache: SSDCache) -> torch.Tensor:
    """``ssd_decode`` of the normed x: the increment; ``cache`` is updated
    in place.  On DTensors each rank convolves its own columns of the conv
    tail (split over "tp" as the cache places them, with ``conv_w``'s) and
    gathers the convolved xBC, of which its heads read theirs."""
    if not isinstance(x, DTensor):
        return ssd_decode(cfg, p, C.norm_apply(cfg, x, scale), cache)[0]
    ax, split, gather = _share(cfg, x)
    sw, sd = C._norm_weights(cfg, scale)
    _, di, _, _, n = _dims(cfg)
    cd = di + 2 * n
    cs = ax.tp is not None and cd % ax.n == 0      # the conv's columns split over "tp"
    c0, c1 = (ax.rank * cd // ax.n, (ax.rank + 1) * cd // ax.n) if cs else (0, cd)
    statep = TP.rows(x, ax, Shard(1) if split else None)
    convp = TP.rows(x, ax, Shard(2) if cs else None)
    for name, want in (("state", statep), ("conv", convp)):
        if tuple(cache[name].placements) != want:
            raise ValueError(f"SSD {name} placed {cache[name].placements}, not {want}")

    def fn(xl, *ws):
        h = C.norm_local(cfg, xl, ws[0] if sw else None, ax)
        *ws, conv, state = ws[len(sw):]
        pw = SimpleNamespace(**dict(zip(_NAMES, ws)))
        proj = _project(h[:, 0, :], pw.in_proj, ax, gather)
        win = torch.cat([conv, _split_proj(di, n, proj)[1][:, None, c0:c1]], dim=1)
        conv.copy_(win[:, 1:, :])
        xbc = _conv_step(win, pw.conv_w, pw.conv_b[c0:c1])
        if cs:
            xbc = TP.all_gather(xbc, ax)
        ws = [None if name in ("conv_w", "conv_b") else w for name, w in zip(_NAMES, ws)]
        dims, local, lproj = _local(cfg, ax, split, ws, proj)
        lxbc = _xbc_channels(cfg, ax, xbc) if split else xbc
        return _decode_mix(dims, local, lproj, lxbc, state, ax if split else None)[:, None, :]

    # the conv's columns split over "tp" even where the heads are not
    dims = sd + [1 if gather else None, 1 if cs else None] + [None] * 5 + [0 if split else None]
    out = TP.region(fn, x, sw + [getattr(p, name) for name in _NAMES], dims,
                    split=split or cs, model_dims=C._norm_model_dims(cfg) + _MODEL_DIMS,
                    extra=(cache["conv"], cache["state"]), extra_placements=(convp, statep),
                    outs=TP.partial(x, ax, split))
    return out.redistribute(x.device_mesh, x.placements)
