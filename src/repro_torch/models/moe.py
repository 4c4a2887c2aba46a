"""Mixture-of-experts layer with sort-based capacity dispatch.

The port of ``repro/models/moe.py``.  Tokens are routed by *sorting* the
(token, expert) assignments by expert id and gathering them into a static
(E, C) layout per batch row, so the expert FFNs cost top_k x
capacity_factor x (expert FFN), not the T^2 of a one-hot dispatch einsum.

Variants:
* qwen2-moe: 60 routed experts top-4 + 4 shared experts (one wide shared
  FFN) behind a sigmoid gate.
* arctic: 128 routed top-2 + a dense FFN residual in parallel.

Where the JAX package vmaps the dispatch over batch rows, the port
dispatches every row at once: each row's slots sit at an offset of
``row * E * C`` in one ``(B * E * C + 1)`` buffer whose last entry takes
the assignments past an expert's capacity (the ``mode="drop"`` row of
``.at[slot].set``).  The sort is stable, as ``jnp.argsort`` is, so the
same tokens overflow.  The combine is a gather: each token sums its at
most k slots in ascending slot order, the order of XLA's serial
scatter-add, with no atomics.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..sharding import context
from .common import FFN, dense_init, ffn, on_meta, pdtype_of


def _expert_stack(gen: torch.Generator, shape, dtype, fan_in: int
                  ) -> nn.Parameter:
    """``dense_init`` of an (E, a, b) stack drawn one expert at a time, so
    no fp32 copy of the whole stack is ever held (arctic's is 17.8 GB)."""
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    if on_meta(gen):
        return nn.Parameter(w)
    scale = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        for e in range(shape[0]):
            w[e] = (torch.randn(shape[1:], generator=gen, device=gen.device)
                    * scale).to(dtype)
    return nn.Parameter(w)


class MoE(nn.Module):
    """Expert stacks allocated at cfg.e_eff (padded); the router emits only
    cfg.n_experts logits, so padded experts are never routed to."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.e_eff, cfg.moe_d_ff
        pd = pdtype_of(cfg)
        self.router = dense_init(gen, (d, cfg.n_experts), pd)
        self.w_gate = _expert_stack(gen, (e, d, ff), pd, fan_in=d)
        self.w_up = _expert_stack(gen, (e, d, ff), pd, fan_in=d)
        self.w_down = _expert_stack(gen, (e, ff, d), pd, fan_in=ff)
        self.shared = self.shared_gate = self.dense = None
        if cfg.n_shared_experts:
            self.shared = FFN(gen, d, cfg.n_shared_experts * ff, cfg)
            self.shared_gate = dense_init(gen, (d, 1), pd)
        if cfg.dense_residual:
            self.dense = FFN(gen, d, cfg.dense_d_ff, cfg)


_TP = "model"
_UNC = context.UNCONSTRAINED


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """``sharding.context.constrain`` on the model axis: the JAX package's
    layout pins around the expert einsums; values unchanged."""
    return context.constrain(x, spec, axes=(_TP,))


class GlobalRouting:
    """The Switch aux loss's routing fractions over a batch that several
    data ranks hold.  ``aux = E * sum_e me_e * ce_e`` is a product of two
    means over the whole batch; a rank that sees only its rows must use the
    batch's ``ce`` (the share of assignments each expert took), or the sum
    of the ranks' terms is not the aux of the batch.  ``me``, the mean
    router probability, stays the rank's own: weighted by the rank's share
    of the rows, the ranks' terms then sum to the batch's aux.

    Two passes (``runtime.steps.shard_train_step``): under :meth:`record`
    each MoE layer adds its assignment counts into the table (the
    all-reduce of the counts); under :meth:`apply` each layer reads the
    summed counts back in place of its own.  The counts are integers in
    fp32, so the batch's ``ce`` is bit for bit the unsharded step's.
    Layers are keyed by module name: ``add_model`` maps each MoE module of
    a model to its name, so the compute models of several devices share
    one table."""

    def __init__(self):
        self.names: Dict[int, str] = {}
        self.counts: Dict[str, torch.Tensor] = {}
        self.totals: Dict[str, int] = {}
        self._mode = "record"

    def add_model(self, model: nn.Module) -> "GlobalRouting":
        for name, m in model.named_modules():
            if isinstance(m, MoE):
                self.names[id(m)] = name
        return self

    @contextlib.contextmanager
    def record(self):
        self._mode = "record"
        token = _ROUTING.set(self)
        try:
            yield self
        finally:
            _ROUTING.reset(token)

    @contextlib.contextmanager
    def apply(self):
        self._mode = "apply"
        token = _ROUTING.set(self)
        try:
            yield self
        finally:
            _ROUTING.reset(token)

    def ce(self, p: "MoE", counts: torch.Tensor, total: int) -> torch.Tensor:
        name = self.names[id(p)]
        if self._mode == "record":
            seen = self.counts.get(name)
            self.counts[name] = (counts.detach() if seen is None else
                                 seen + counts.detach().to(seen.device))
            self.totals[name] = self.totals.get(name, 0) + total
            return counts / total
        return (self.counts[name] / self.totals[name]).to(counts.device)


_ROUTING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routing", default=None)


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.n_experts_per_token
            / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8 (sublane alignment)


def _dispatch(cfg: ArchConfig, top_e: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of every batch row at once.

    top_e: (B, S, k) expert ids.  Returns (slot_tok (B, E*C): the token
    each slot holds, -1 where empty; slot_of (B, S, k): the slot within
    its row of each assignment, E*C where it overflowed its expert's
    capacity and was dropped)."""
    b, s, k = top_e.shape
    e = cfg.e_eff
    dev = top_e.device
    flat_e = top_e.reshape(b, s * k)
    n = s * k
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = order // k                                   # token of each entry
    ar = torch.arange(n, device=dev).expand(b, n)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=-1).values
    rank = ar - seg_start
    slot = torch.where(rank < cap, se * cap + rank, e * cap)  # overflow drop
    # row offsets into one (B*E*C + 1) buffer; its last entry is the drop row
    row = torch.arange(b, device=dev)[:, None] * (e * cap)
    glob = torch.where(slot < e * cap, slot + row, b * e * cap)
    slot_tok = torch.full((b * e * cap + 1,), -1, dtype=torch.int64,
                          device=dev)
    slot_tok.scatter_(0, glob.reshape(-1), st.reshape(-1))
    slot_of = torch.empty_like(slot)
    slot_of.scatter_(1, order, slot)
    return slot_tok[:-1].reshape(b, e * cap), slot_of.reshape(b, s, k)


def moe_ffn(p: MoE, cfg: ArchConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Router: softmax over the real experts in fp32, top-k, renormalised
    combine weights (the qwen2-moe convention).  Aux loss: Switch-style
    load balancing over the real experts.
    """
    b, s, d = x.shape
    e, k = cfg.e_eff, cfg.n_experts_per_token
    cap = _capacity(cfg, s)                     # per-row capacity
    dt = x.dtype

    router_logits = (x @ p.router.to(dt)).float()
    probs = torch.softmax(router_logits, dim=-1)              # (B, S, E_real)
    top_w, top_e = torch.topk(probs, k, dim=-1)               # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e (real experts)
    me = probs.mean(dim=(0, 1))
    counts = F.one_hot(top_e, cfg.n_experts).float().sum(dim=(0, 1, 2))
    routing = _ROUTING.get()
    ce = (counts / (b * s * k) if routing is None
          else routing.ce(p, counts, b * s * k))
    aux = cfg.n_experts * torch.sum(me * ce)

    slot_tok, slot_of = _dispatch(cfg, top_e, cap)
    held = (slot_tok >= 0)[..., None]
    gx = torch.gather(x, 1, slot_tok.clamp(min=0)[..., None].expand(-1, -1, d))
    gx = torch.where(held, gx, 0.0).reshape(b, e, cap, d)     # (B, E, C, d)

    gx = _constrain(gx, (_UNC, _TP, None, None))
    h = torch.einsum("becd,edf->becf", gx, p.w_up.to(dt))
    g = torch.einsum("becd,edf->becf", gx, p.w_gate.to(dt))
    h = _constrain(F.silu(g) * h, (_UNC, _TP, None, None))
    y = torch.einsum("becf,efd->becd", h, p.w_down.to(dt))
    y = _constrain(y, (_UNC, _TP, None, None))

    # combine: each token gathers its slots in ascending slot order (a
    # dropped assignment reads the zero row E*C) and sums them in dt
    slots, idx = torch.sort(slot_of, dim=-1)
    w = torch.gather(top_w, -1, idx).to(dt)
    y = torch.cat([y.reshape(b, e * cap, d), y.new_zeros((b, 1, d))], dim=1)
    ys = torch.gather(y, 1, slots.reshape(b, s * k)[..., None]
                      .expand(-1, -1, d)).reshape(b, s, k, d)
    out = ys[:, :, 0] * w[..., 0, None]
    for j in range(1, k):
        out = out + ys[:, :, j] * w[..., j, None]

    xt = x.reshape(b * s, d)
    if p.shared is not None:
        sg = torch.sigmoid((xt @ p.shared_gate.to(dt)).float()).to(dt)
        out = out + (sg * ffn(p.shared, cfg, xt)).reshape(b, s, d)
    if p.dense is not None:
        out = out + ffn(p.dense, cfg, xt).reshape(b, s, d)
    return out, aux
