"""Config-driven model assembly: the decoder-only transformer (dense, vlm).

The port of ``repro/models/model.py``'s transformer.  Every family of the
JAX package exposes one functional API (``ModelApi``); the port keeps it,
over an ``nn.Module``:

  init(generator) -> params                   (a :class:`Transformer`)
  forward(params, batch) -> (logits, aux)     (training / prefill)
  init_cache(batch, cache_len) -> cache       (decode state)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

where the JAX package scans stacked layer leaves, the module holds an
``nn.ModuleList`` of blocks.  Remat follows ``cfg.remat``: ``"full"``
checkpoints each block, ``"dots"`` checkpoints each block but saves its
matmul outputs (the JAX ``dots_with_no_batch_dims_saveable`` policy: plain
products, not the batched attention ones), ``"none"`` keeps everything.
The decode cache is updated in place (the JAX package donates it).

The other families (moe, ssm, hybrid, encdec) are not ported yet:
:func:`get_model` names the ROADMAP entry for each.
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
from .common import (Attention, Embedding, FFN, RMSNorm, attention,
                     attention_decode, dtype_of, embed_tokens, ffn, logits,
                     rmsnorm, rope_angles)


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    forward_hidden: Optional[Callable[..., Tuple[torch.Tensor,
                                                 torch.Tensor]]] = None


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


class Block(nn.Module):
    """One decoder layer: pre-norm attention, then a pre-norm gated FFN."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        pd = common.pdtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, pd, gen.device)
        self.ln2 = RMSNorm(cfg.d_model, pd, gen.device)
        self.attn = Attention(gen, cfg)
        self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg)


def _layer_fwd(cfg: ArchConfig, p: Block, x, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    x = x + attention(p.attn, cfg, h, cos, sin)
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


def _layer_decode(cfg: ArchConfig, p: Block, x, ck, cv, pos, cos, sin):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    a, ck, cv = attention_decode(p.attn, cfg, h, ck, cv, pos, cos, sin)
    x = x + a
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + ffn(p.ffn, cfg, h)


def _positions_for(cfg: ArchConfig, b: int, s: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)      # text: t = h = w
    return pos


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks and the final norm, drawn from
    ``gen`` on its device."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(gen, cfg)
        self.layers = nn.ModuleList(Block(gen, cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, common.pdtype_of(cfg), gen.device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def forward(self, batch: dict, return_hidden: bool = False):
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_tokens(self.embed, cfg, tokens)
        if cfg.modality == "vision" and "patches" in batch:
            # stub frontend: precomputed patch embeddings prefix the text
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
            s = x.shape[1]
        pos = _positions_for(cfg, b, s, device=x.device)
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                               cfg.mrope_sections)
        body = _remat(cfg, functools.partial(_layer_fwd, cfg))
        for layer in self.layers:
            x = body(layer, x, cos, sin)
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, aux
        return logits(self.embed, cfg, x), aux

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V), cache),
        the cache written in place."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = embed_tokens(self.embed, cfg, tokens)
        ppos = _positions_for(cfg, b, 1, offset=int(pos), device=x.device)
        cos, sin = rope_angles(ppos, cfg.head_dim, cfg.rope_theta,
                               cfg.mrope_sections)
        for i, layer in enumerate(self.layers):
            x = _layer_decode(cfg, layer, x, cache["k"][i], cache["v"][i],
                              pos, cos, sin)
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        return logits(self.embed, cfg, x), cache


def make_transformer(cfg: ArchConfig) -> ModelApi:
    def init(gen: torch.Generator) -> Transformer:
        return Transformer(cfg, gen)

    def forward(params: Transformer, batch, return_hidden=False):
        return params(batch, return_hidden=return_hidden)

    def decode_step(params: Transformer, cache, tokens, pos):
        return params.decode_step(cache, tokens, pos)

    def init_cache(batch: int, cache_len: int, device=None) -> dict:
        """Zero K and V caches (L, B, T, KV, D) in the compute dtype on
        ``device`` (default: the card)."""
        device = dispatch.resolve_device(device)
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}

    return ModelApi(cfg, init, forward, init_cache, decode_step,
                    forward_hidden=functools.partial(forward,
                                                     return_hidden=True))


_NOT_PORTED = {
    "moe": "ROADMAP queue 1 item 1 (models/moe.py: qwen2-moe, arctic)",
    "ssm": "ROADMAP queue 1 item 2 (models/ssm.py: mamba2)",
    "hybrid": "ROADMAP queue 1 item 3 (models/rglru.py and the hybrid "
              "family: recurrentgemma)",
    "encdec": "ROADMAP queue 1 item 4 (enc-dec: seamless-m4t)",
}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see "
            f"{_NOT_PORTED[cfg.family]}")
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return make_transformer(cfg)
