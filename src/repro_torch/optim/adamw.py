"""AdamW with decoupled weight decay, global-norm clipping, warmup-cosine
schedules and a configurable moment dtype.

The port of ``repro/optim/adamw.py``: its own arithmetic in the JAX
formula's order (``repro/optim/adamw.py:60-89``), step by step in fp32.
Parameters are a ``{name: tensor}`` dict (``dict(model.named_parameters())``)
and are updated in place, as are the moments: the JAX package donates
them.  An fp32 leaf is updated through in-place ops (each op's value is the
formula's); a bf16 leaf goes through an fp32 copy and is cast back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    schedule: str = "cosine"       # cosine | linear | constant


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an f32 0-dim
    tensor on the step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones((), device=step.device)
    return cfg.lr * warm * decay


def init(cfg: OptConfig, params: Tensors) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def init_sharded(cfg: OptConfig, params: dict) -> dict:
    """:func:`init` for parameters sharded over a mesh (``{name:
    sharding.rules.Sharded}``): each rank's moments are zeros of its own
    blocks' shape, made on its device (no whole moment is ever held), and
    every rank holds the step counter."""
    from ..sharding import rules
    dt = getattr(torch, cfg.moment_dtype)
    some = next(iter(params.values()))
    return {"m": {n: rules.zeros(s.shape, dt, s.spec, s.mesh)
                  for n, s in params.items()},
            "v": {n: rules.zeros(s.shape, dt, s.spec, s.mesh)
                  for n, s in params.items()},
            "step": rules.zeros((), torch.int32, (), some.mesh)}


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def update(cfg: OptConfig, grads: Tensors, state: dict, params: Tensors,
           grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Tensors, dict, dict]:
    """One AdamW step: ``params`` and ``state``'s moments updated in place.
    Returns (params, new state, metrics).  ``grad_norm``, when given, is
    the clip's global norm: a rank that updates its blocks alone passes the
    norm over every block of the model, not of its own."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m32 = m.float().mul_(b1).add_((1 - b1) * g)
        v32 = v.float().mul_(b2).add_(((1 - b2) * g).mul_(g))
        del g
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:  # decoupled wd on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p32 = p.float().sub_(lr * delta)
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if src is not dst:       # a bf16 leaf: its fp32 copy cast back
                dst.copy_(src)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
