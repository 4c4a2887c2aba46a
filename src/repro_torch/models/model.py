"""Config-driven model assembly for the ten configs' five families.

The port of ``repro/models/model.py``.  Every family of the JAX package
exposes one functional API (``ModelApi``); the port keeps it, over an
``nn.Module``:

  init(generator) -> params                   (the family's module)
  forward(params, batch) -> (logits, aux)     (training / prefill)
  init_cache(batch, cache_len) -> cache       (decode state)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

The families: the decoder-only transformer (dense, vlm, and moe with
``models/moe.py``'s layer in place of the FFN), Mamba2 (ssm,
``models/ssm.py``), RecurrentGemma (hybrid: groups of (RG-LRU, RG-LRU,
local attention) and an RG-LRU tail, ``models/rglru.py``) and the
seamless encoder-decoder (encdec).  Where the JAX package scans stacked
layer leaves, a module holds an ``nn.ModuleList`` of blocks.  Remat
follows ``cfg.remat``: ``"full"`` checkpoints each block, ``"dots"``
checkpoints each block but saves its matmul outputs (the JAX
``dots_with_no_batch_dims_saveable`` policy: plain products, not the
batched attention ones), ``"none"`` keeps everything.  Decode caches are
updated in place (the JAX package donates them).

The enc-dec API adds ``encode(params, frames)`` and
``fill_cross_cache(params, cache, frames)``, which writes each decoder
layer's cross-attention K/V, computed as the forward computes them.  The
JAX package's decode reads those from its cache and names such a
function, but has none: its ``init_cache`` leaves them zero.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..kernels import dispatch
from . import common
from .common import (Attention, Embedding, FFN, RMSNorm, _gqa_out,
                     _gqa_scores, _project, apply_rope, attention,
                     attention_decode, dtype_of, embed_tokens, ffn, logits,
                     rmsnorm, rope_angles)
from .moe import MoE, moe_ffn
from .rglru import RGLRU, rglru_cache_init, rglru_decode, rglru_forward
from .ssm import Mamba, mamba_cache_init, mamba_decode, mamba_forward


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    forward_hidden: Optional[Callable[..., Tuple[torch.Tensor,
                                                 torch.Tensor]]] = None
    encode: Optional[Callable[..., torch.Tensor]] = None
    fill_cross_cache: Optional[Callable[..., Any]] = None


# plain matmuls: what "dots" saves (batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)

        def saved_dots(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=ctx)
        return saved_dots

    def full(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return full


def _positions_for(cfg: ArchConfig, b: int, s: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)      # text: t = h = w
    return pos


def _rope(cfg: ArchConfig, b: int, s: int, device, offset: int = 0):
    pos = _positions_for(cfg, b, s, offset=int(offset), device=device)
    return rope_angles(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _norm(cfg: ArchConfig, gen: torch.Generator) -> RMSNorm:
    return RMSNorm(cfg.d_model, common.pdtype_of(cfg), gen.device)


class LM(nn.Module):
    """What every family shares: the config, the embedding, the final norm
    and the head."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(gen, cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def _head(self, x: torch.Tensor, aux: torch.Tensor, return_hidden: bool):
        """The forward's end: the final norm, then (hidden or logits,
        aux)."""
        x = rmsnorm(self.ln_f, x, self.cfg.norm_eps)
        if return_hidden:
            return x, aux
        return logits(self.embed, self.cfg, x), aux

    def _decode_logits(self, x: torch.Tensor) -> torch.Tensor:
        return logits(self.embed, self.cfg,
                      rmsnorm(self.ln_f, x, self.cfg.norm_eps))


# ===========================================================================
# Decoder-only transformer (dense / moe / vlm)
# ===========================================================================


class Block(nn.Module):
    """One decoder layer: pre-norm attention, then a pre-norm gated FFN or
    (moe) the mixture-of-experts layer."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.attn = Attention(gen, cfg)
        if cfg.family == "moe":
            self.moe = MoE(gen, cfg)
        else:
            self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg)


def _mlp(cfg: ArchConfig, p: Block, h):
    """The block's FFN or MoE: (out, aux)."""
    if cfg.family == "moe":
        return moe_ffn(p.moe, cfg, h)
    return ffn(p.ffn, cfg, h), _zero(h)


def _layer_fwd(cfg: ArchConfig, p: Block, x, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + attention(p.attn, cfg, h, cos, sin)
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    y, aux = _mlp(cfg, p, h)
    return x + y, aux


def _layer_decode(cfg: ArchConfig, p: Block, x, ck, cv, pos, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    a, ck, cv = attention_decode(p.attn, cfg, h, ck, cv, pos, cos, sin)
    x = x + a
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + _mlp(cfg, p, h)[0]


class Transformer(LM):
    """Embedding, ``cfg.n_layers`` blocks and the final norm, drawn from
    ``gen`` on its device."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        self.layers = nn.ModuleList(Block(gen, cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _norm(cfg, gen)

    def forward(self, batch: dict, return_hidden: bool = False):
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_tokens(self.embed, cfg, tokens)
        if cfg.modality == "vision" and "patches" in batch:
            # stub frontend: precomputed patch embeddings prefix the text
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
            s = x.shape[1]
        cos, sin = _rope(cfg, b, s, x.device)
        body = _remat(cfg, functools.partial(_layer_fwd, cfg))
        auxs = []
        for layer in self.layers:
            x, aux = body(layer, x, cos, sin)
            auxs.append(aux)
        return self._head(x, torch.stack(auxs).mean(), return_hidden)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V), cache),
        the cache written in place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, cfg, tokens)
        cos, sin = _rope(cfg, tokens.shape[0], 1, x.device, offset=pos)
        for i, layer in enumerate(self.layers):
            x = _layer_decode(cfg, layer, x, cache["k"][i], cache["v"][i],
                              pos, cos, sin)
        return self._decode_logits(x), cache

    @staticmethod
    def new_cache(cfg: ArchConfig, batch: int, cache_len: int, device
                  ) -> dict:
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


# ===========================================================================
# Mamba2 (ssm)
# ===========================================================================


class MambaBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln = _norm(cfg, gen)
        self.mamba = Mamba(gen, cfg)


def _mamba_fwd(cfg: ArchConfig, p: MambaBlock, x):
    return x + mamba_forward(p.mamba, cfg, rmsnorm(p.ln, x, cfg.norm_eps))


class Mamba2(LM):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        self.layers = nn.ModuleList(MambaBlock(gen, cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _norm(cfg, gen)

    def forward(self, batch: dict, return_hidden: bool = False):
        x = embed_tokens(self.embed, self.cfg, batch["tokens"])
        body = _remat(self.cfg, functools.partial(_mamba_fwd, self.cfg))
        for layer in self.layers:
            x = body(layer, x)
        return self._head(x, _zero(x), return_hidden)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        cfg = self.cfg
        x = embed_tokens(self.embed, cfg, tokens)
        for i, p in enumerate(self.layers):
            h = rmsnorm(p.ln, x, cfg.norm_eps)
            x = x + mamba_decode(p.mamba, cfg, h, cache["conv"][i],
                                 cache["ssm"][i])
        return self._decode_logits(x), cache

    @staticmethod
    def new_cache(cfg: ArchConfig, batch: int, cache_len: int, device
                  ) -> dict:
        one = mamba_cache_init(cfg, batch, dtype_of(cfg), device)
        return {k: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                               device=device) for k, t in one.items()}


# ===========================================================================
# RecurrentGemma (hybrid): groups of (rglru, rglru, local-attn) + rglru tail
# ===========================================================================


def _hy_counts(cfg: ArchConfig) -> Tuple[int, int]:
    period = len(cfg.block_pattern)          # 3
    n_groups = cfg.n_layers // period
    return n_groups, cfg.n_layers - n_groups * period   # tail: rglru layers


class RGLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.rg = RGLRU(gen, cfg)
        self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg, gated=True)


class AttnLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.attn = Attention(gen, cfg)
        self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg, gated=True)


class Group(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.rg1 = RGLayer(gen, cfg)
        self.rg2 = RGLayer(gen, cfg)
        self.attn = AttnLayer(gen, cfg)


def _rg_fwd(cfg: ArchConfig, p: RGLayer, x):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + rglru_forward(p.rg, cfg, h)
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


def _group_fwd(cfg: ArchConfig, p: Group, x, cos, sin):
    x = _rg_fwd(cfg, p.rg1, x)
    x = _rg_fwd(cfg, p.rg2, x)
    a = p.attn
    h = rmsnorm(a.ln1, x, cfg.norm_eps)
    x = x + attention(a.attn, cfg, h, cos, sin, window=cfg.local_window)
    h = rmsnorm(a.ln2, x, cfg.norm_eps)
    return x + ffn(a.ffn, cfg, h)


def _rg_dec(cfg: ArchConfig, p: RGLayer, x, c: dict, i: int):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + rglru_decode(p.rg, cfg, h, c["conv"][i], c["h"][i])
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


class Hybrid(LM):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        n_groups, tail = _hy_counts(cfg)
        self.groups = nn.ModuleList(Group(gen, cfg) for _ in range(n_groups))
        self.ln_f = _norm(cfg, gen)
        self.tail = (nn.ModuleList(RGLayer(gen, cfg) for _ in range(tail))
                     if tail else None)

    def forward(self, batch: dict, return_hidden: bool = False):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(self.embed, cfg, tokens)
        cos, sin = _rope(cfg, *tokens.shape, x.device)
        gbody = _remat(cfg, functools.partial(_group_fwd, cfg))
        for g in self.groups:
            x = gbody(g, x, cos, sin)
        tbody = _remat(cfg, functools.partial(_rg_fwd, cfg))
        for layer in self.tail or ():
            x = tbody(layer, x)
        return self._head(x, _zero(x), return_hidden)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        cfg = self.cfg
        x = embed_tokens(self.embed, cfg, tokens)
        cos, sin = _rope(cfg, tokens.shape[0], 1, x.device, offset=pos)
        c = cache["groups"]
        for i, g in enumerate(self.groups):
            x = _rg_dec(cfg, g.rg1, x, c["rg1"], i)
            x = _rg_dec(cfg, g.rg2, x, c["rg2"], i)
            a = g.attn
            h = rmsnorm(a.ln1, x, cfg.norm_eps)
            y, _, _ = attention_decode(a.attn, cfg, h, c["k"][i], c["v"][i],
                                       pos, cos, sin, window=cfg.local_window)
            x = x + y
            h = rmsnorm(a.ln2, x, cfg.norm_eps)
            x = x + ffn(a.ffn, cfg, h)
        for i, layer in enumerate(self.tail or ()):
            x = _rg_dec(cfg, layer, x, cache["tail"], i)
        return self._decode_logits(x), cache

    @staticmethod
    def new_cache(cfg: ArchConfig, batch: int, cache_len: int, device
                  ) -> dict:
        """The RG-LRU states, and a ring buffer of min(local_window,
        cache_len) keys and values for each group's local attention."""
        n_groups, tail = _hy_counts(cfg)
        dt = dtype_of(cfg)

        def stacked(n):
            one = rglru_cache_init(cfg, batch, dt, device)
            return {k: torch.zeros((n,) + t.shape, dtype=t.dtype,
                                   device=device) for k, t in one.items()}
        win = min(cfg.local_window, cache_len)
        kv = (n_groups, batch, win, cfg.n_kv_heads, cfg.head_dim)
        cache = {"groups": {
            "rg1": stacked(n_groups), "rg2": stacked(n_groups),
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device)}}
        if tail:
            cache["tail"] = stacked(tail)
        return cache


# ===========================================================================
# Encoder-decoder (seamless-m4t): audio-frontend stub + text decoder
# ===========================================================================


class EncLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.attn = Attention(gen, cfg)
        # the classic transformer FFN: ungated (relu)
        self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg, gated=False)


class DecLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.ln3 = _norm(cfg, gen)
        self.self = Attention(gen, cfg)
        self.cross = Attention(gen, cfg)
        self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg, gated=False)


def _grouped_attention(cfg: ArchConfig, p: Attention, q, k, v):
    """Unmasked grouped attention of q (B, S, H, D) over k, v (B, T, KV, D),
    through the output projection."""
    b, s = q.shape[:2]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = q.dtype
    q = q.reshape(b, s, kv, h // kv, hd) * (hd ** -0.5)
    scores = _gqa_scores(q, k.to(dt)).float()
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = _gqa_out(probs, v.to(dt)).reshape(b, s, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))


def _enc_attention(cfg: ArchConfig, p: Attention, x, cos, sin):
    """Bidirectional self-attention (no causal mask)."""
    q = apply_rope(_project(x, p.wq), cos, sin)
    k = apply_rope(_project(x, p.wk), cos, sin)
    return _grouped_attention(cfg, p, q, k, _project(x, p.wv))


def _cross_attention(cfg: ArchConfig, p: Attention, x, mem_k, mem_v):
    return _grouped_attention(cfg, p, _project(x, p.wq), mem_k, mem_v)


def _mem_kv(p: Attention, mem: torch.Tensor):
    return _project(mem, p.wk), _project(mem, p.wv)


def _enc_fwd(cfg: ArchConfig, p: EncLayer, x, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + _enc_attention(cfg, p.attn, h, cos, sin)
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


def _dec_fwd(cfg: ArchConfig, p: DecLayer, x, mem, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + attention(p.self, cfg, h, cos, sin)
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    x = x + _cross_attention(cfg, p.cross, h, *_mem_kv(p.cross, mem))
    h = rmsnorm(p.ln3, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


class EncDec(LM):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        self.enc = nn.ModuleList(EncLayer(gen, cfg)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecLayer(gen, cfg)
                                 for _ in range(cfg.n_layers))
        self.ln_enc = _norm(cfg, gen)
        self.ln_f = _norm(cfg, gen)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, d) -> the encoder's memory (B, S_enc, d)."""
        cfg = self.cfg
        b, s, _ = frames.shape
        x = frames.to(dtype_of(cfg))
        cos, sin = _rope(cfg, b, s, x.device)
        body = _remat(cfg, functools.partial(_enc_fwd, cfg))
        for layer in self.enc:
            x = body(layer, x, cos, sin)
        return rmsnorm(self.ln_enc, x, cfg.norm_eps)

    def forward(self, batch: dict, return_hidden: bool = False):
        cfg = self.cfg
        mem = self.encode(batch["frames"])
        tokens = batch["tokens"]
        x = embed_tokens(self.embed, cfg, tokens)
        cos, sin = _rope(cfg, *tokens.shape, x.device)
        body = _remat(cfg, functools.partial(_dec_fwd, cfg))
        for layer in self.dec:
            x = body(layer, x, mem, cos, sin)
        return self._head(x, _zero(x), return_hidden)

    def fill_cross_cache(self, cache: dict, frames: torch.Tensor) -> dict:
        """Encode ``frames`` and write each decoder layer's cross K/V into
        ``cache["ck"]`` / ``cache["cv"]`` in place, as the forward computes
        them."""
        mem = self.encode(frames)
        for i, layer in enumerate(self.dec):
            k, v = _mem_kv(layer.cross, mem)
            cache["ck"][i].copy_(k)
            cache["cv"][i].copy_(v)
        return cache

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """Reads the cross K/V that :meth:`fill_cross_cache` wrote."""
        cfg = self.cfg
        x = embed_tokens(self.embed, cfg, tokens)
        cos, sin = _rope(cfg, tokens.shape[0], 1, x.device, offset=pos)
        for i, p in enumerate(self.dec):
            h = rmsnorm(p.ln1, x, cfg.norm_eps)
            a, _, _ = attention_decode(p.self, cfg, h, cache["k"][i],
                                       cache["v"][i], pos, cos, sin)
            x = x + a
            h = rmsnorm(p.ln2, x, cfg.norm_eps)
            x = x + _cross_attention(cfg, p.cross, h, cache["ck"][i],
                                     cache["cv"][i])
            h = rmsnorm(p.ln3, x, cfg.norm_eps)
            x = x + ffn(p.ffn, cfg, h)
        return self._decode_logits(x), cache

    @staticmethod
    def new_cache(cfg: ArchConfig, batch: int, cache_len: int, device,
                  enc_len: Optional[int] = None) -> dict:
        """Self-attention K/V of ``cache_len`` and cross K/V of ``enc_len``
        (default ``cfg.frontend_len``) frames, zero until
        :meth:`fill_cross_cache`."""
        enc_len = enc_len or cfg.frontend_len
        kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        ckv = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        dt = dtype_of(cfg)
        return {"k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "ck": torch.zeros(ckv, dtype=dt, device=device),
                "cv": torch.zeros(ckv, dtype=dt, device=device)}


# ===========================================================================
# Registry
# ===========================================================================


_FAMILIES = {"dense": Transformer, "vlm": Transformer, "moe": Transformer,
             "ssm": Mamba2, "hybrid": Hybrid, "encdec": EncDec}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    cls = _FAMILIES[cfg.family]

    def init(gen: torch.Generator) -> LM:
        return cls(cfg, gen)

    def forward(params: LM, batch, return_hidden=False):
        return params(batch, return_hidden=return_hidden)

    def decode_step(params: LM, cache, tokens, pos):
        return params.decode_step(cache, tokens, pos)

    def init_cache(batch: int, cache_len: int, device=None, **kw):
        """Zero decode state on ``device`` (default: the card), in the
        layout of the JAX package's cache."""
        return cls.new_cache(cfg, batch, cache_len,
                             dispatch.resolve_device(device), **kw)

    api = ModelApi(cfg, init, forward, init_cache, decode_step,
                   forward_hidden=functools.partial(forward,
                                                    return_hidden=True))
    if cls is EncDec:
        api.encode = lambda params, frames: params.encode(frames)
        api.fill_cross_cache = (lambda params, cache, frames:
                                params.fill_cross_cache(cache, frames))
    return api

