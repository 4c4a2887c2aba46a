"""RG-LRU recurrent block (RecurrentGemma / Griffin)  [arXiv:2402.19427].

The port of ``repro/models/rglru.py``.  Block: two input projections to
lru_width; one branch goes conv1d(4) -> RG-LRU, the other is a GeLU gate;
their product -> output projection.

RG-LRU:  r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x),
         a_t = exp(-c * softplus(Lambda) * r_t)   (c = 8),
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

The JAX package scans the linear recurrence with ``associative_scan`` over
the sequence.  Eager PyTorch has no such scan, and a loop over 2,048 steps
of 18 layers would be tens of thousands of launches a step, so training
runs :func:`linear_scan`, a log-depth Hillis-Steele doubling (11 passes at
S = 2,048).  Decode is the single-step update, its states written in
place.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .common import _act, dense_init, on_meta, pdtype_of
from .ssm import causal_conv

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        d, lw = cfg.d_model, cfg.lru_width
        pd = pdtype_of(cfg)
        dev = gen.device
        self.in_x = dense_init(gen, (d, lw), pd)
        self.in_gate = dense_init(gen, (d, lw), pd)
        self.conv_w = dense_init(gen, (cfg.d_conv, lw), pd, fan_in=cfg.d_conv)
        self.conv_b = nn.Parameter(torch.zeros((lw,), dtype=pd, device=dev))
        self.w_a = dense_init(gen, (lw, lw), pd)
        self.b_a = nn.Parameter(torch.zeros((lw,), dtype=pd, device=dev))
        self.w_i = dense_init(gen, (lw, lw), pd)
        self.b_i = nn.Parameter(torch.zeros((lw,), dtype=pd, device=dev))
        # Lambda in [2, 6), so that a^c spans ~(0.9, 0.999) as in the paper
        if on_meta(gen):
            self.lam = nn.Parameter(torch.empty((lw,), dtype=pd, device=dev))
        else:
            lam = torch.rand((lw,), generator=gen, device=dev) * 4.0 + 2.0
            self.lam = nn.Parameter(lam.to(pd))
        self.out = dense_init(gen, (lw, d), pd, fan_in=lw)


def _gates(p: RGLRU, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decay a and the gated input b_t, both fp32."""
    dt = x.dtype
    r = torch.sigmoid((x @ p.w_a.to(dt) + p.b_a.to(dt)).float())
    i = torch.sigmoid((x @ p.w_i.to(dt) + p.b_i.to(dt)).float())
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * i * x.float()
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, by Hillis-Steele
    doubling: after the pass at offset d, entry t holds the composed map
    of steps (t - 2d, t].  ceil(log2 S) passes, each out of place, so
    autograd differentiates through it."""
    s = a.shape[1]
    d = 1
    while d < s:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def rglru_forward(p: RGLRU, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence recurrent block.  x: (B, S, d_model)."""
    dt = x.dtype
    gate = _act("gelu", x @ p.in_gate.to(dt))
    u = x @ p.in_x.to(dt)
    u = causal_conv(u, p.conv_w.to(dt), p.conv_b.to(dt))
    a, b = _gates(p, u)
    h = linear_scan(a, b)
    h = h.to(dt) * gate
    return h @ p.out.to(dt)


def rglru_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    lw = cfg.lru_width
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, lw), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, lw), dtype=torch.float32, device=device),
    }


def rglru_decode(p: RGLRU, cfg: ArchConfig, x: torch.Tensor,
                 conv: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d_model); ``conv`` (B, K-1, lw) and
    ``h`` (B, lw), this layer's states, are updated in place."""
    dt = x.dtype
    x0 = x[:, 0]
    gate = _act("gelu", x0 @ p.in_gate.to(dt))
    u = x0 @ p.in_x.to(dt)
    hist = torch.cat([conv, u[:, None, :]], dim=1)
    u = torch.einsum("bkc,kc->bc", hist, p.conv_w.to(dt)) + p.conv_b.to(dt)
    conv.copy_(hist[:, 1:])
    a, b = _gates(p, u)
    h.copy_(a * h + b)
    out = (h.to(dt) * gate) @ p.out.to(dt)
    return out[:, None, :]
