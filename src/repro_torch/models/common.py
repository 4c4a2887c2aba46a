"""Shared building blocks: norms, RoPE / M-RoPE, GQA attention (train and
decode), gated FFNs, embeddings.

The port of ``repro/models/common.py``.  The parameters live in small
``nn.Module``s (:class:`RMSNorm`, :class:`Attention`, :class:`FFN`,
:class:`Embedding`) whose tensors keep the JAX package's names and layouts
(``wq`` (d, h_eff, hd), ``wo`` (h_eff, hd, d), ...), so that a JAX
parameter tree loads leaf for leaf (``convert.lm_params_from_numpy``).  The
functions below take those modules as the JAX functions take their param
dicts, and compute in the same order: matmuls in the compute dtype, scores
and softmax statistics in fp32, ``NEG_INF`` masking.

Attention is plain PyTorch, as the JAX package's is plain einsums: the
blockwise path (:func:`_flash_attention`) mirrors its ``lax.scan`` online
softmax with a checkpoint on each key block; no fused attention call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig

NEG_INF = -2.0e38

FLASH_BLOCK = 1024
FLASH_MIN_SEQ = 2048


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers (the draws are the port's own: torch.Generator, not JAX keys)
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` to build a model on the ``meta``
    device: the init helpers draw nothing from it and allocate nothing,
    so a full-width model's shapes and dtypes cost no host memory (the
    JAX package's ``jax.eval_shape(api.init, key)``).  ``torch.Generator``
    itself refuses ``meta``."""

    device = torch.device("meta")


def on_meta(gen) -> bool:
    """Does ``gen`` build on the ``meta`` device (draw nothing)?"""
    return gen.device.type == "meta"


def _empty(shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))


def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None) -> nn.Parameter:
    if on_meta(gen):
        return _empty(shape, dtype)
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device)
    return nn.Parameter((w * (1.0 / np.sqrt(fan_in))).to(dtype))


def embed_init(gen: torch.Generator, shape, dtype) -> nn.Parameter:
    if on_meta(gen):
        return _empty(shape, dtype)
    w = torch.randn(shape, generator=gen, device=gen.device)
    return nn.Parameter((w * 0.02).to(dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * norm.scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Tuple[int, ...] = ()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.

    positions: (B, S) int for standard RoPE, or (3, B, S) for M-RoPE
    (temporal / height / width position ids; for pure text all three rows
    are equal and M-RoPE coincides with RoPE).  Returns cos, sin:
    (B, S, head_dim/2) f32.
    """
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=dev) / half))
    if positions.dim() == 2:
        ang = positions.float()[..., None] * inv_freq          # (B, S, half)
    else:
        ang3 = positions.float()[..., None] * inv_freq       # (3, B, S, half)
        sel = _sections(half, tuple(mrope_sections), dev)
        ang = torch.take_along_dim(ang3.permute(1, 2, 3, 0),
                                   sel[None, None, :, None], dim=-1)[..., 0]
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=64)
def _sections(half: int, mrope_sections: Tuple[int, ...],
              device: torch.device) -> torch.Tensor:
    """Each rotary frequency's M-RoPE section (t, h or w) on ``device``,
    copied there once."""
    idx = np.zeros((half,), np.int64)
    start = 0
    for i, s in enumerate(mrope_sections or (half,)):
        idx[start:start + s] = i
        start += s
    return torch.as_tensor(idx, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2).  Llama-style rotate-half."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Query/output heads are allocated at cfg.h_eff (padded); the padded
    heads' contribution is zero-masked in :func:`attention`, so the
    function equals the unpadded arch exactly."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig,
                 d_model: Optional[int] = None):
        super().__init__()
        d = d_model or cfg.d_model
        h, kv, hd = cfg.h_eff, cfg.n_kv_heads, cfg.head_dim
        pd = pdtype_of(cfg)
        self.wq = dense_init(gen, (d, h, hd), pd, fan_in=d)
        self.wk = dense_init(gen, (d, kv, hd), pd, fan_in=d)
        self.wv = dense_init(gen, (d, kv, hd), pd, fan_in=d)
        self.wo = dense_init(gen, (h, hd, d), pd, fan_in=cfg.n_heads * hd)


def _kv_map(cfg: ArchConfig) -> np.ndarray:
    """Static head -> kv-head map (real grouping h // g for real heads;
    padded heads read kv head 0 and are masked out)."""
    g = cfg.n_heads // cfg.n_kv_heads
    idx = np.zeros((cfg.h_eff,), np.int64)
    idx[:cfg.n_heads] = np.arange(cfg.n_heads) // g
    return idx


def _head_mask(cfg: ArchConfig) -> np.ndarray:
    return (np.arange(cfg.h_eff) < cfg.n_heads).astype(np.float32)


def _vocab_mask(cfg: ArchConfig) -> np.ndarray:
    vmask = np.zeros((cfg.v_eff,), np.float32)
    vmask[cfg.vocab_size:] = NEG_INF
    return vmask


_STATIC = {"kv_map": _kv_map, "head_mask": _head_mask,
           "vocab_mask": _vocab_mask,
           "perm": lambda cfg: _decode_perms(cfg)[0],
           "inv": lambda cfg: _decode_perms(cfg)[1]}


@functools.lru_cache(maxsize=256)
def _static(cfg: ArchConfig, name: str, device: torch.device
            ) -> torch.Tensor:
    """``cfg``'s static index or mask ``name`` on ``device``, copied there
    once: a copy from pageable host memory on every layer's call would
    wait for the card each time."""
    return torch.as_tensor(_STATIC[name](cfg), device=device)


def _masked_heads(cfg: ArchConfig, out: torch.Tensor) -> torch.Tensor:
    """Zero the padded heads of out (B, S, h_eff, D)."""
    mask = _static(cfg, "head_mask", out.device).to(out.dtype)
    return out * mask[None, None, :, None]


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Q,KV,G,D), k: (B,T,KV,D) -> (B,KV,G,Q,T) (grouped, no kv
    repeat)."""
    return torch.einsum("bqhgd,bthd->bhgqt", q, k)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhgqt,bthd->bqhgd", probs, v)


def _flash_block(q, kblk, vblk, m, l, acc, jbase: int, window: int):
    """One key block of the online softmax: scores of ``q`` against
    ``kblk`` in fp32, masked; the running (max, denominator, accumulator)
    rescaled and extended."""
    s, block_k = q.shape[1], kblk.shape[1]
    dev = q.device
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kblk).float()
    iq = torch.arange(s, device=dev)
    j = jbase + torch.arange(block_k, device=dev)
    mask = j[None, :] <= iq[:, None]
    if window > 0:
        mask = mask & (j[None, :] > iq[:, None] - window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vblk)
    acc = acc * alpha.transpose(1, 2)[..., None] + pv.float()
    return m_new, l_new, acc


def _flash_attention(q: torch.Tensor, kx: torch.Tensor, v: torch.Tensor,
                     window: int = 0, block_k: int = FLASH_BLOCK
                     ) -> torch.Tensor:
    """Blockwise causal attention with online softmax (flash-style, plain
    PyTorch).

    q, kx, v: (B, S, H, D), q pre-scaled.  Loops over key blocks carrying
    the running (max, denominator, accumulator), so the (S, S) score matrix
    is never materialised: peak score memory is (B, H, S, block_k).  Each
    block runs under a checkpoint when gradients are on, so the backward
    pass recomputes per-block scores instead of storing them (the JAX
    package's ``jax.checkpoint`` on its scan body).
    """
    b, s, h, hd = q.shape
    nb = s // block_k
    m = torch.full((b, h, s), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled()
    for i in range(nb):
        sl = slice(i * block_k, (i + 1) * block_k)
        args = (q, kx[:, sl], v[:, sl], m, l, acc, i * block_k, window)
        if remat:
            m, l, acc = checkpoint(_flash_block, *args, use_reentrant=False)
        else:
            m, l, acc = _flash_block(*args)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) in x's dtype."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def attention(p: Attention, cfg: ArchConfig, x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, window: int = 0
              ) -> torch.Tensor:
    """Causal self-attention over a full sequence (training / prefill).

    GQA replicates KV heads up to the H query heads with a static gather
    (idx = h // G), as the JAX package does.  window > 0 => local
    (sliding-window) attention.  Sequences of at least ``FLASH_MIN_SEQ``
    that ``FLASH_BLOCK`` divides take the blockwise path.
    """
    b, s, d = x.shape
    h, kv, hd = cfg.h_eff, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = apply_rope(_project(x, p.wq), cos, sin)
    kx = apply_rope(_project(x, p.wk), cos, sin)
    v = _project(x, p.wv)
    if h != kv:
        idx = _static(cfg, "kv_map", x.device)
        kx = kx[:, :, idx, :]
        v = v[:, :, idx, :]
    q = q * (hd ** -0.5)
    if s >= FLASH_MIN_SEQ and s % FLASH_BLOCK == 0:
        out = _flash_attention(q, kx, v, window=window)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kx).float()
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = j <= i
        if window > 0:
            mask = mask & (j > i - window)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if cfg.h_eff != cfg.n_heads:   # zero padded heads (exactness, zero grads)
        out = _masked_heads(cfg, out)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))


def _decode_perms(cfg: ArchConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv): grouped slot (kv_i, j) <- real head kv_i * g_real + j
    (padded slots read head 0); and real head -> its grouped slot."""
    h, kv = cfg.h_eff, cfg.n_kv_heads
    g_real, g = cfg.n_heads // kv, h // kv
    perm = np.zeros((h,), np.int64)
    for kv_i in range(kv):
        for j in range(g):
            perm[kv_i * g + j] = kv_i * g_real + j if j < g_real else 0
    inv = np.zeros((h,), np.int64)
    for rh in range(cfg.n_heads):
        inv[rh] = (rh // g_real) * g + (rh % g_real)
    return perm, inv


def attention_decode(p: Attention, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     cos: torch.Tensor, sin: torch.Tensor, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache.

    x: (B, 1, d); cache_k/v: (B, T, KV, D) (a ring buffer for local
    attention); pos: the current position (an int).  The new key and
    value are written into the caches in place (the JAX package donates
    them).  Returns (out (B, 1, d), cache_k, cache_v).

    Decode keeps the grouped (KV, G) formulation, so the cache stays at KV
    heads.  With padded query heads, a static permutation maps heads into
    (KV, G_eff) groups that preserve the real grouping h // g; padded group
    slots are masked before the output projection.
    """
    b, _, d = x.shape
    h, kv, hd = cfg.h_eff, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    t = cache_k.shape[1]
    dt = x.dtype
    pos = int(pos)
    q = apply_rope(_project(x, p.wq), cos, sin)
    kx = apply_rope(_project(x, p.wk), cos, sin)
    v = _project(x, p.wv)
    slot = pos % t if window > 0 else pos   # ring buffer for local attention
    cache_k[:, slot] = kx[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    if h != cfg.n_heads:
        q = q[:, :, _static(cfg, "perm", x.device), :]
    q = q.reshape(b, 1, kv, g, hd) * (hd ** -0.5)
    scores = _gqa_scores(q, cache_k.to(dt)).float()       # (B,KV,G,1,T)
    j = torch.arange(t, device=x.device)
    if window > 0:
        valid = (j <= slot) | (pos >= t)   # ring buffer full once wrapped
    else:
        valid = j <= pos
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = _gqa_out(probs, cache_v.to(dt)).reshape(b, 1, h, hd)
    if h != cfg.n_heads:
        out = _masked_heads(cfg, out[:, :, _static(cfg, "inv", x.device), :])
    out = torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

class FFN(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, ff: int,
                 cfg: ArchConfig, gated: bool = True):
        super().__init__()
        pd = pdtype_of(cfg)
        self.up = dense_init(gen, (d, ff), pd)
        self.down = dense_init(gen, (ff, d), pd, fan_in=ff)
        self.gate = dense_init(gen, (d, ff), pd) if gated else None


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":            # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def ffn(p: FFN, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    up = x @ p.up.to(dt)
    if p.gate is not None:
        up = _act(cfg.act, x @ p.gate.to(dt)) * up
    else:
        up = _act(cfg.act, up)
    return up @ p.down.to(dt)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """Tables allocated at cfg.v_eff (vocab padded); padded logits get a
    NEG_INF additive mask in :func:`logits`, so softmax / CE are exact."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        pd = pdtype_of(cfg)
        self.tok = embed_init(gen, (cfg.v_eff, cfg.d_model), pd)
        self.out = (None if cfg.tie_embeddings
                    else dense_init(gen, (cfg.d_model, cfg.v_eff), pd))


def embed_tokens(p: Embedding, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Rows of the table in the compute dtype.  Gathers, then casts the
    rows: the values of the JAX package's cast-then-gather, without a cast
    of the whole table."""
    return F.embedding(tokens.long(), p.tok).to(dtype_of(cfg))


def logits(p: Embedding, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        lg = x @ p.tok.to(dt).T
    else:
        lg = x @ p.out.to(dt)
    if cfg.v_eff != cfg.vocab_size:
        lg = lg + _static(cfg, "vocab_mask", lg.device).to(lg.dtype)
    return lg
