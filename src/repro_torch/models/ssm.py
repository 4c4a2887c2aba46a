"""Mamba2 / SSD (state-space duality) block  [arXiv:2405.21060].

The port of ``repro/models/ssm.py``.  Training uses the chunked SSD
algorithm: an intra-chunk quadratic term (matmuls over the chunk length
Q) and an inter-chunk linear recurrence over the S / Q chunks, which the
port runs as a loop (the JAX package's ``associative_scan``; 8 chunks at
mamba2's seq 2,048 and chunk 256).  Decode is the O(1) state recurrence,
its conv and SSM states written in place.

The intra-chunk decay ``exp(cs_i - cs_j)`` is masked *before* the exp:
``exp(where(j <= i, cs_i - cs_j, -inf))``.  For j > i the exponent is
positive and over a 256-step chunk passes 88.7, where fp32's exp
overflows; masking after the exp (as the JAX package does) leaves the
forward equal but makes the backward 0 x inf = NaN.  Masking first gives
the same forward bit for bit (exp(-inf) = 0) and finite gradients.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads, state N,
one group (B and C shared across heads).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .common import RMSNorm, dense_init, pdtype_of, rmsnorm


class Mamba(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        d = cfg.d_model
        din, ns, hh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = din + 2 * ns
        pd = pdtype_of(cfg)
        dev = gen.device
        self.in_proj = dense_init(gen, (d, 2 * din + 2 * ns + hh), pd)
        self.conv_w = dense_init(gen, (cfg.d_conv, conv_dim), pd,
                                 fan_in=cfg.d_conv)
        self.conv_b = nn.Parameter(torch.zeros((conv_dim,), dtype=pd,
                                               device=dev))
        # A = -exp(A_log) = -1 at init
        self.A_log = nn.Parameter(torch.zeros((hh,), dtype=pd, device=dev))
        self.D = nn.Parameter(torch.ones((hh,), dtype=pd, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros((hh,), dtype=pd, device=dev))
        self.norm = RMSNorm(din, pd, dev)
        self.out_proj = dense_init(gen, (din, d), pd, fan_in=din)


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    din, ns = cfg.d_inner, cfg.ssm_state
    z = proj[..., :din]
    xbc = proj[..., din:din + din + 2 * ns]
    dt = proj[..., din + din + 2 * ns:]
    return z, xbc, dt


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C) -> (B, S, C), as the
    JAX package's explicit shifted sum."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b


def mamba_forward(p: Mamba, cfg: ArchConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Full-sequence SSD.  x: (B, S, d_model) -> (B, S, d_model).  S must
    be a multiple of cfg.ssm_chunk."""
    bsz, s, _ = x.shape
    din, ns, hh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_headdim
    q = cfg.ssm_chunk
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk "
                         f"{q}")
    nc = s // q
    dt_ = x.dtype

    proj = x @ p.in_proj.to(dt_)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = F.silu(causal_conv(xbc, p.conv_w.to(dt_), p.conv_b.to(dt_)))
    xin = xbc[..., :din].reshape(bsz, s, hh, hp)
    bm = xbc[..., din:din + ns]                          # (B, S, N)
    cm = xbc[..., din + ns:]                             # (B, S, N)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B, S, H)
    a_ = -torch.exp(p.A_log.float())                     # (H,)

    def ch(t, trail):  # (B, S, ...) -> (B, nc, Q, ...)
        return t.reshape((bsz, nc, q) + trail)

    a = ch(dt * a_, (hh,))               # (B, nc, Q, H) log-decay increments
    cs = torch.cumsum(a, dim=2)          # inclusive
    xdt = ch(xin.float() * dt[..., None], (hh, hp))
    bc = ch(bm.float(), (ns,))
    cc = ch(cm.float(), (ns,))

    # intra-chunk: M[i, j, h] = exp(cs_i - cs_j) (C_i . B_j), j <= i; the
    # exponent masked before the exp (module docstring)
    ii = torch.arange(q, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B, nc, Qi, Qj, H)
    decay = torch.exp(torch.where(mask, diff, -torch.inf))
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)
    m = g[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xdt)

    # chunk states: S_c = sum_j exp(cs_last - cs_j) B_j (x dt)_j
    w_end = torch.exp(cs[:, :, -1:, :] - cs)             # (B, nc, Q, H)
    s_c = torch.einsum("bcjn,bcjhp->bchpn", bc, xdt * w_end[..., None])

    # inter-chunk recurrence, chunk by chunk: the state before chunk c
    d_tot = torch.exp(cs[:, :, -1, :])                   # (B, nc, H)
    state = torch.zeros_like(s_c[:, 0])
    prev = []
    for c in range(nc):
        prev.append(state)
        state = d_tot[:, c, :, None, None] * state + s_c[:, c]
    s_prev = torch.stack(prev, dim=1)                    # (B, nc, H, P, N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, s_prev) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, hh, hp)
    y = y + p.D.float()[None, None, :, None] * xin.float()
    y = y.reshape(bsz, s, din).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(p.norm, y, cfg.norm_eps)
    return y @ p.out_proj.to(dt_)


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    din, ns = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, din + 2 * ns),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, ns),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: Mamba, cfg: ArchConfig, x: torch.Tensor, conv: torch.Tensor,
                 ssm: torch.Tensor) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d_model); ``conv`` (B, K-1, C) and
    ``ssm`` (B, H, P, N), this layer's states, are updated in place."""
    bsz = x.shape[0]
    din, ns, hh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_headdim
    dt_ = x.dtype

    proj = x[:, 0] @ p.in_proj.to(dt_)
    z, xbc, dt_raw = _split_proj(cfg, proj)

    hist = torch.cat([conv, xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", hist, p.conv_w.to(dt_))
                 + p.conv_b.to(dt_))
    conv.copy_(hist[:, 1:])

    xin = xbc[..., :din].reshape(bsz, hh, hp).float()
    bm = xbc[..., din:din + ns].float()
    cm = xbc[..., din + ns:].float()
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B, H)
    a_ = -torch.exp(p.A_log.float())
    da = torch.exp(dt * a_)                              # (B, H)

    ssm.copy_(da[:, :, None, None] * ssm
              + torch.einsum("bn,bhp,bh->bhpn", bm, xin, dt))
    y = torch.einsum("bn,bhpn->bhp", cm, ssm)
    y = y + p.D.float()[None, :, None] * xin
    y = y.reshape(bsz, din).to(dt_) * F.silu(z)
    y = rmsnorm(p.norm, y, cfg.norm_eps)
    return (y @ p.out_proj.to(dt_))[:, None, :]
