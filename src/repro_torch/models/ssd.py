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
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

__all__ = ["SSD", "init_ssd", "ssd_forward", "ssd_decode", "init_ssd_cache"]

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


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    _, di, _, _, n = _dims(cfg)
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel (k, C), x (B, S, C), then SiLU."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return _silu(out + b)


def _gated_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm (float32, 1 + scale) of x * silu(z), the gate applied in
    x's dtype."""
    return C.rmsnorm(x * _silu(z), scale)


def _dt_a(p: SSD, dt: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(A_log), both float32."""
    return F.softplus(dt.float() + p.dt_bias.float()), -torch.exp(p.A_log.float())


def ssd_forward(cfg: ModelConfig, p: SSD, x: torch.Tensor, return_cache: bool = False):
    """Chunked SSD over x (B, S, D) -> (B, S, D); S must be a multiple of
    ``ssm_chunk``.  ``return_cache=True`` also returns the decode handoff:
    the final state (float32) and the last k-1 raw projections."""
    _, di, p_, h, n = _dims(cfg)
    b, s, _ = x.shape
    q = cfg.ssm_chunk
    if s % q:
        raise AssertionError((s, q))
    c = s // q
    dt_ = x.dtype

    proj = x @ p.in_proj.to(dt_)
    z, xbc_raw, dt = _split_proj(cfg, proj)
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
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], seg, float("-inf"))).to(dt_)
    xdt = xs * dt[..., None].to(dt_)                             # (B,C,Q,H,P)
    cb = torch.einsum("bcln,bcsn->bcls", Cm, Bm)                 # (B,C,Q,Q)
    y = torch.einsum("bclsh,bcshp->bclhp", cb[..., None] * L, xdt)

    # per-chunk states, then the recurrence across chunks: chunk i reads the
    # state left by chunks < i
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs).to(dt_)   # (B,C,Q,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bm, xdt * decay_out[..., None])
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # (B,C,H)
    carry = torch.zeros((b, h, p_, n), dtype=dt_, device=x.device)
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None].to(dt_) + states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # (B,C,H,P,N)

    decay_in = torch.exp(dA_cs).to(dt_)                          # (B,C,Q,H)
    y = y + torch.einsum("bcln,bchpn->bclhp", Cm, prev_states) * decay_in[..., None]
    y = y + xs * p.D.to(dt_)[:, None]
    y = _gated_norm(y.reshape(b, s, di), z, p.norm_scale)
    out = y @ p.out_proj.to(dt_)
    if return_cache:
        return out, {"state": carry.float(),
                     "conv": xbc_raw[:, s - (cfg.ssm_conv - 1):, :].clone()}
    return out


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
    b = x.shape[0]
    dt_ = x.dtype

    proj = x[:, 0, :] @ p.in_proj.to(dt_)
    z, xbc, dt = _split_proj(cfg, proj)
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)    # (B,k,conv_dim)
    xbc = _silu(torch.einsum("bkc,kc->bc", win, p.conv_w.to(dt_)) + p.conv_b.to(dt_))
    cache["conv"].copy_(win[:, 1:, :])

    xs = xbc[:, :di].reshape(b, h, p_)
    Bm = xbc[:, di:di + n].float()
    Cm = xbc[:, di + n:].float()
    dtv, A = _dt_a(p, dt)                                        # (B,H), (H,)
    # state * decay + (x * dt) outer B, in place: addcmul_ writes in the
    # state's own layout (a broadcast outer product comes out permuted, and
    # adding it took a strided pass four times slower on the card)
    st = cache["state"]
    st.mul_(torch.exp(dtv * A)[:, :, None, None])
    st.addcmul_((xs.float() * dtv[..., None])[..., None], Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", st, Cm).to(dt_)
    y = y + xs * p.D.to(dt_)[:, None]
    y = _gated_norm(y.reshape(b, di), z, p.norm_scale)
    return (y @ p.out_proj.to(dt_))[:, None, :], cache
