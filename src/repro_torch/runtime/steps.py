"""train_step / serve_step factories, unsharded and over a mesh of ranks.

The port of ``repro/runtime/steps.py``.

``make_train_step``: CE loss (next-token) -> grads -> global-norm clip ->
AdamW, with ``cfg.grad_accum`` micro-batches per update.  Parameters and
optimizer state are updated in place (the JAX package donates them).

``make_serve_step``: one-token decode against the cache, written in place.
When ``cfg.lsh_cache`` is on, the paper's technique runs in the serving
path: the step also emits a W^2-LSH signature of each sequence's output
distribution (softmax -> inverse CDF at QMC nodes -> Eq. 3 embedding ->
p-stable hash), which a server uses to dedupe sequences in the same state.
The hash is K1 (``kernels/ops.pstable_hash``) on the card.

``shard_train_step`` / ``shard_serve_step``: the same steps over a
``launch.mesh.PodMesh`` of ranks (one process drives every rank, as the
JAX package's single controller does), laid out by
``sharding.rules``.  Between steps each rank holds only its blocks: of the
parameters and AdamW's moments (``param_specs``: TP over ``model``, FSDP
over ``data`` where ``cfg.fsdp_params``), and of the decode cache
(``cache_specs``: batch over ``data``, KV length over ``model`` where it
divides).  Inside a step the layers compute from *gathered* blocks (the
FSDP pattern of ``repro/sharding/rules.py:7-10``): each device the ranks
use gathers the whole parameters into a module of its own at the start
of the step and frees it at the end.  Then:

* train: the batch splits over the data ranks by ``batch_axis`` (rows in
  contiguous blocks, as a sharded batch dim lies), inside the interleaved
  micro-batch split (micro-batch i takes rows i, i + accum, ...: each
  data rank runs its own rows of each micro-batch).  A rank's share of a
  micro-batch's loss is weighted by its share of the rows, so the ranks'
  gradients sum to the micro-batch's.  Each data rank's gradient is
  all-reduced over the data axis (the collective); the clip's global norm
  is taken over that whole reduced gradient, and each rank's AdamW then
  updates its own blocks from its slice of it.  The Switch aux loss is a
  product of batch means: a micro-batch whose rows sit on several ranks is
  first routed once without gradients to all-reduce its experts' counts
  (``models.moe.GlobalRouting``), so every rank's aux uses the batch's.
* serve: the cache's blocks are gathered on rank (0, 0)'s device, where
  the unsharded decode step runs on the gathered parameters and the
  signature (K1) is taken once a step; the updated cache is scattered
  back into the ranks' blocks.

A replicated batch (``batch_axis`` None) is run by data rank 0 alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, ShapeConfig
from ..core import hashes, wasserstein
from ..kernels import ops
from ..models import common as mcommon
from ..models.model import ModelApi
from ..models.moe import GlobalRouting
from ..optim import adamw
from ..sharding import context as shctx
from ..sharding import rules


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


# ---------------------------------------------------------------------------
# sharded steps over a data x model mesh of ranks
# ---------------------------------------------------------------------------


class _Compute:
    """The module each device computes with inside a step: the family's
    module built on ``meta``, allocated (uninitialised) on the device when
    the step first needs it there, the ranks' blocks gathered into it, and
    dropped at the step's end (:meth:`release`)."""

    def __init__(self, api: ModelApi):
        self.api = api
        self.models: Dict[torch.device, torch.nn.Module] = {}

    def model(self, dev: torch.device, params: Dict[str, rules.Sharded]
              ) -> torch.nn.Module:
        m = self.models.get(dev)
        if m is None:
            m = self.api.init(mcommon.MetaGenerator()).to_empty(device=dev)
            named = dict(m.named_parameters())
            for n, s in params.items():
                rules.gather(s, out=named[n].data)
            self.models[dev] = m
        return m

    def release(self) -> None:
        self.models.clear()


def shard_params(params, pspec: Dict[str, rules.Spec], mesh
                 ) -> Dict[str, rules.Sharded]:
    """A model's parameters (or a ``{name: tensor}`` dict) laid out over
    ``mesh`` by ``pspec``: each rank's blocks, on its device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    with torch.no_grad():
        return {n: rules.shard(t.detach(), pspec[n], mesh)
                for n, t in params.items()}


def _place_batch(batch: dict, bspec: dict, mesh) -> dict:
    return {k: v if isinstance(v, rules.Sharded) else
            rules.shard(torch.as_tensor(v), bspec[k], mesh)
            for k, v in batch.items()}


def _row_blocks(leaf: rules.Sharded, mesh):
    """(data rank, slice of the global rows it holds) of
    every data rank that holds rows of its own (a replicated dim: data
    rank 0 alone)."""
    out, seen = [], set()
    for di in range(mesh.shape[mesh.axis_names[0]]):
        rows = leaf.slices(di, 0)[0]
        if rows.start not in seen:
            seen.add(rows.start)
            out.append((di, rows))
    return out


def shard_train_step(api: ModelApi, cfg: ArchConfig,
                     opt_cfg: adamw.OptConfig, mesh, shape: ShapeConfig,
                     params_shape: Any, batch_shape: Any):
    """The train step over ``mesh`` (see the module docstring).  Returns
    (step, pspec, ospec, bspec) as the JAX package does;
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    takes the parameters as :func:`shard_params` lays them out, the state
    as ``adamw.init_sharded`` does (both updated in place), and the global
    batch (tensors anywhere, or already ``rules.Sharded`` by ``bspec``)."""
    pspec = rules.param_specs(cfg, params_shape, mesh)
    ospec = {"m": pspec, "v": pspec, "step": ()}
    bspec = rules.batch_specs(cfg, batch_shape, mesh, shape.global_batch)
    loss_fn = make_loss_fn(api, cfg)
    accum = max(1, cfg.grad_accum)
    compute = _Compute(api)

    def parts_of(batch: dict):
        """{data rank: (device, [(micro-batch, weight, rows)])}."""
        first = next(iter(batch.values()))
        n_rows = first.shape[0]
        if n_rows % accum:
            raise ValueError(f"global batch {n_rows} does not split into "
                             f"{accum} micro-batches")
        micro = n_rows // accum
        out = {}
        for di, rows in _row_blocks(first, mesh):
            dev = mesh.devices[di][0]
            local = {k: v.block(di, 0) for k, v in batch.items()}
            mine = []
            for i in range(accum):
                idx = [j - rows.start for j in range(rows.start, rows.stop)
                       if j % accum == i]
                if idx:
                    sel = torch.as_tensor(idx, device=dev)
                    mine.append((i, len(idx) / micro,
                                 {k: v.index_select(0, sel)
                                  for k, v in local.items()}))
            out[di] = (dev, mine)
        return out

    def routings(params, parts) -> Dict[int, GlobalRouting]:
        """The batch's expert counts of each micro-batch held by several
        data ranks: one forward per rank's rows, without gradients."""
        if cfg.family != "moe":
            return {}
        held: Dict[int, list] = {}
        for di, (dev, mine) in parts.items():
            for i, _, rows in mine:
                held.setdefault(i, []).append((dev, rows))
        out = {}
        for i, holders in held.items():
            if len(holders) < 2:
                continue
            gr = GlobalRouting()
            for dev, rows in holders:
                model = compute.model(dev, params)
                gr.add_model(model)
                with torch.no_grad(), gr.record():
                    api.forward_hidden(model, rows)
            out[i] = gr
        return out

    def train_step(params, opt_state, batch):
        with shctx.use_mesh(mesh):
            try:
                return step_body(params, opt_state, batch)
            finally:
                compute.release()

    def step_body(params, opt_state, batch):
        batch = _place_batch(batch, bspec, mesh)
        parts = parts_of(batch)
        routing = routings(params, parts)
        dev0 = mesh.devices[0][0]
        gsum: Dict[str, torch.Tensor] = {}
        lsum = torch.zeros((), device=dev0)
        last = {"ce": torch.zeros((), device=dev0),
                "aux": torch.zeros((), device=dev0)}
        for di, (dev, mine) in parts.items():
            if not mine:
                continue
            model = compute.model(dev, params)
            named = dict(model.named_parameters())
            for p in named.values():
                p.grad = None
            for i, w, rows in mine:
                ctx = (routing[i].apply() if i in routing
                       else contextlib.nullcontext())
                with ctx:
                    l, m = loss_fn(model, rows)
                    (l if w == 1.0 else w * l).backward()
                lsum = lsum + (w * l.detach()).to(dev0)
                if i == accum - 1:
                    for k in last:
                        last[k] = last[k] + (w * m[k].detach()).to(dev0)
            # the all-reduce of the data ranks' gradients, into rank (0, 0)'s
            for n, p in named.items():
                g, p.grad = p.grad, None
                if n in gsum:
                    gsum[n].add_(g.to(dev0))
                else:
                    gsum[n] = g if g.device == dev0 else g.to(dev0)
                del g
        for g in gsum.values():
            g.div_(accum)
        gnorm = adamw.global_norm(gsum)
        opt_metrics = None
        for di, mi in rules.ranks(mesh):
            dev = mesh.devices[di][mi]
            mine_p = {n: s.block(di, mi) for n, s in params.items()}
            grads = {n: gsum[n][s.slices(di, mi)].to(dev)
                     for n, s in params.items()}
            state = {"m": {n: s.block(di, mi)
                           for n, s in opt_state["m"].items()},
                     "v": {n: s.block(di, mi)
                           for n, s in opt_state["v"].items()},
                     "step": opt_state["step"].block(di, mi)}
            _, new_state, om = adamw.update(opt_cfg, grads, state, mine_p,
                                            grad_norm=gnorm.to(dev))
            opt_state["step"].blocks[di][mi] = new_state["step"]
            if opt_metrics is None:
                opt_metrics = om
        del gsum
        metrics = dict(last, loss=lsum / accum, **opt_metrics)
        return params, opt_state, metrics

    return train_step, pspec, ospec, bspec


def shard_serve_step(api: ModelApi, cfg: ArchConfig, mesh,
                     shape: ShapeConfig, params_shape: Any, cache_shape: Any,
                     lsh: Optional[LshServeParams] = None):
    """The serve step over ``mesh`` (see the module docstring).  Returns
    (step, pspec, cspec) as the JAX package does; ``step(params, cache,
    tokens, pos) -> (out, cache)`` takes the parameters as
    :func:`shard_params` lays them out and the cache as ``rules.shard_tree``
    lays it out by ``cspec`` (written in place); ``out`` holds the whole
    batch's ``logits`` (B, 1, V), ``next`` and ``lsh_sig`` on rank (0,
    0)'s device."""
    pspec = rules.param_specs(cfg, params_shape, mesh)
    cspec = rules.cache_specs(cfg, cache_shape, mesh, shape.global_batch)
    compute = _Compute(api)

    def put(s, f):
        if isinstance(s, dict):
            for k in s:
                put(s[k], f[k])
        else:
            rules.scatter(f, s)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        dev0 = mesh.devices[0][0]
        with shctx.use_mesh(mesh):
            try:
                model = compute.model(dev0, params)
                full = rules.gather_tree(cache, dev0)
                logits, full = api.decode_step(model, full, tokens.to(dev0),
                                               int(pos))
                put(cache, full)
            finally:
                compute.release()
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = {"logits": logits, "next": next_tok}
        if lsh is not None and cfg.lsh_cache:
            out["lsh_sig"] = lsh_signature(lsh, logits)
        return out, cache

    return serve_step, pspec, cspec
