"""train_step / serve_step factories.

The port of ``repro/runtime/steps.py:36-205`` (the unsharded factories;
``shard_train_step`` / ``shard_serve_step`` wait for the port's sharding
rules).

``make_train_step``: CE loss (next-token) -> grads -> global-norm clip ->
AdamW, with ``cfg.grad_accum`` micro-batches per update.  Parameters and
optimizer state are updated in place (the JAX package donates them).

``make_serve_step``: one-token decode against the cache, written in place.
When ``cfg.lsh_cache`` is on, the paper's technique runs in the serving
path: the step also emits a W^2-LSH signature of each sequence's output
distribution (softmax -> inverse CDF at QMC nodes -> Eq. 3 embedding ->
p-stable hash), which a server uses to dedupe sequences in the same state.
The hash is K1 (``kernels/ops.pstable_hash``) on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core import hashes, wasserstein
from ..kernels import ops
from ..models import common as mcommon
from ..models.model import ModelApi
from ..optim import adamw


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _token_ce(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logsumexp(lg) - lg[target] per position, in fp32."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE.  logits: (B, S, V) predicting targets (B, S)."""
    return _token_ce(logits, targets).mean()


def make_loss_fn(api: ModelApi, cfg: ArchConfig, aux_weight: float = 0.01,
                 loss_chunks: int = 8):
    """Chunked next-token CE.

    Full (B, S, V) fp32 logits would be the largest tensor of a train step
    (llama3.2-3b at 4 x 2,048 tokens: 4.2 GB).  Instead the final
    projection and softmax-CE run chunk by chunk over S, each chunk under a
    checkpoint: logits only ever exist for S / loss_chunks positions, and
    the backward pass recomputes them per chunk.
    """
    def chunk_ce(params, hk, tk, wk):
        lg = mcommon.logits(params.embed, cfg, hk)
        return (_token_ce(lg, tk) * wk).sum()

    def loss_fn(params, batch):
        hidden, aux = api.forward_hidden(params, batch)
        ntok = batch["tokens"]
        if cfg.modality == "vision":  # patch prefix positions carry no loss
            hidden = hidden[:, -ntok.shape[1]:]
        b, s, d = hidden.shape
        dev = hidden.device
        # targets: next token; final position masked out
        tgt = torch.cat([ntok[:, 1:], ntok.new_zeros((b, 1))], dim=1)
        wgt = torch.cat([torch.ones((b, s - 1), device=dev),
                         torch.zeros((b, 1), device=dev)], dim=1)
        nch = loss_chunks if s % loss_chunks == 0 else 1
        w = s // nch
        total = torch.zeros((), device=dev)
        for c in range(nch):
            sl = slice(c * w, (c + 1) * w)
            args = (params, hidden[:, sl], tgt[:, sl], wgt[:, sl])
            if torch.is_grad_enabled():
                part = checkpoint(chunk_ce, *args, use_reentrant=False)
            else:
                part = chunk_ce(*args)
            total = total + part
        ce = total / torch.clamp(wgt.sum(), min=1.0)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    return loss_fn


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

def accumulate_grads(loss_fn, params, batch: dict, accum: int):
    """The loss and its gradient over ``accum`` micro-batches: each
    parameter's ``.grad`` ends as the mean of the micro-batches' gradients,
    summed in fp32 as the JAX package's accumulator.  The split is the JAX
    package's interleaved one (B -> (B/accum, accum) -> transpose):
    micro-batch i takes rows i, i + accum, ....  Returns (mean loss, the
    last micro-batch's metrics), detached."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    if accum == 1:
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        loss = loss.detach()
    else:
        lsum = torch.zeros((), device=params.device)
        for i in range(accum):
            mbatch = {k: v[i::accum] for k, v in batch.items()}
            l, metrics = loss_fn(params, mbatch)
            l.backward()
            lsum = lsum + l.detach()
        for p in named.values():
            p.grad.div_(accum)
        loss = lsum / accum
    return loss, {k: v.detach() for k, v in metrics.items()}


def make_train_step(api: ModelApi, cfg: ArchConfig, opt_cfg: adamw.OptConfig):
    """Gradient-accumulated train step: ``cfg.grad_accum`` micro-batches per
    optimizer update.  ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is the model (updated in place),
    ``batch`` a dict of tensors on its device."""
    loss_fn = make_loss_fn(api, cfg)
    accum = max(1, cfg.grad_accum)

    def train_step(params, opt_state, batch):
        loss, metrics = accumulate_grads(loss_fn, params, batch, accum)
        named = dict(params.named_parameters())
        grads = {n: p.grad for n, p in named.items()}
        _, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state,
                                                 named)
        for p in named.values():
            p.grad = None
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve_step (+ LSH semantic-cache signatures: the paper in the serving path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LshServeParams:
    """Static hashing state for the serving-path semantic cache."""
    nodes: torch.Tensor      # (N,) quantile levels (QMC)
    volume: float
    support: torch.Tensor    # (V,) numeric support grid for the distribution
    alpha: torch.Tensor      # (N, K) p-stable projections
    b: torch.Tensor          # (K,)
    r: float

    @classmethod
    def create(cls, generator: torch.Generator, cfg: ArchConfig,
               n_embed: int = 64, n_hashes: int = 16, r: float = 1.0
               ) -> "LshServeParams":
        """Sobol nodes, and alpha and b drawn from ``generator``, on the
        generator's device."""
        dev = generator.device
        nodes, vol = wasserstein.icdf_nodes_qmc(n_embed, device=dev)
        fam = hashes.PStableHash.create(generator, n_embed, n_hashes, r=r,
                                        p=2.0)
        support = torch.linspace(-1.0, 1.0, cfg.vocab_size, device=dev)
        return cls(nodes=nodes, volume=vol, support=support,
                   alpha=fam.alpha, b=fam.b, r=r)


def lsh_signature(lsh: LshServeParams, logits: torch.Tensor) -> torch.Tensor:
    """W^2-LSH signature of the per-sequence output distribution.

    logits: (B, 1, V) -> int32 (B, K).  Remark 1 end to end: the softmax
    as a distribution over the numeric support, its inverse CDF embedded
    (Eq. 3) with the MC method, hashed with the p-stable family by K1:
    ``floor(emb @ alpha / r + b)``.
    """
    emb = wasserstein.w2_embedding_logits(
        logits[:, 0, :], lsh.support, lsh.nodes, lsh.volume)   # (B, N)
    return ops.pstable_hash(emb.contiguous(), lsh.alpha, lsh.b, lsh.r)


def make_serve_step(api: ModelApi, cfg: ArchConfig,
                    lsh: Optional[LshServeParams] = None):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = api.decode_step(params, cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = {"logits": logits, "next": next_tok}
        if lsh is not None and cfg.lsh_cache:
            out["lsh_sig"] = lsh_signature(lsh, logits)
        return out, new_cache

    return serve_step
