"""Fault-tolerant training driver.

The port of ``repro/runtime/driver.py``, on the port's checkpoints
(``checkpoint/checkpoint.py``):

* auto-resume from the latest complete checkpoint (crash -> rerun ->
  continues);
* periodic async checkpointing (atomic, keep-last-k);
* a count of non-finite steps, with a bound (``max_nan_skips``);
* per-step heartbeat with a straggler deadline: steps exceeding
  ``deadline_s`` invoke ``on_straggler(step, seconds)`` (at fleet scale:
  mark the host slow, re-mesh; here: logged and counted);
* ``put_batch`` places each batch before the step (the sharded step's
  batch over the mesh's data ranks: ``launch/train.py --mesh-devices``);
* deterministic data restart: the pipeline is a pure function of step, so
  a resumed run consumes the identical stream.

The parameters are a model (updated in place; a resume copies into it) or
a ``{name: sharding.rules.Sharded}`` dict (the sharded step's; a resume
places each leaf's blocks on its mesh as the leaf lays them out, whatever
mesh the checkpoint was saved from).

After a non-finite loss the state is the step's output, as in the JAX
package's code (``repro/runtime/driver.py:80-87``; its docstring says the
step is skipped): the port's step updates the parameters in place.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt
from ..sharding import rules


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 200
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    deadline_s: float = 600.0
    max_nan_skips: int = 10


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    nan_skips: int
    straggler_events: int
    resumed_from: Optional[int]


def _state_tree(params, opt_state) -> dict:
    """What a checkpoint holds: the parameters by name (a module's
    ``named_parameters``, or a ``{name: tensor}`` dict) and the optimizer
    state."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {"params": params, "opt": opt_state}


@torch.no_grad()
def _load(params, restored: dict):
    """The parameters to carry on with: a model gets the restored tensors
    copied in place; a dict of sharded leaves is replaced."""
    if not isinstance(params, torch.nn.Module):
        return restored
    named = dict(params.named_parameters())
    for name, t in restored.items():
        named[name].copy_(t)
    return params


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, rules.Sharded):
        return leaf.block(0, 0).device
    return leaf.device


def train_loop(driver_cfg: DriverConfig, train_step, params, opt_state,
               get_batch: Callable[[int], Any],
               put_batch: Callable[[Any], Any] = lambda b: b,
               on_straggler: Optional[Callable[[int, float], None]] = None,
               log: Callable[[str], None] = print) -> TrainResult:
    """Run (or resume) training.  ``train_step(params, opt, batch) ->
    (params, opt, metrics)``, where ``params`` is the model (updated in
    place) or the sharded step's dict of blocks, and ``metrics["loss"]`` a
    scalar tensor.  ``put_batch`` places ``get_batch(step)`` before the
    step; ``on_straggler(step, seconds)`` hears of each step past the
    deadline."""
    resumed_from = None
    latest = ckpt.latest_step(driver_cfg.ckpt_dir)
    if latest is not None:
        tree = _state_tree(params, opt_state)
        dev = _device_of(next(iter(tree["params"].values())))
        restored = ckpt.restore(driver_cfg.ckpt_dir, latest, tree,
                                device=dev)
        params = _load(params, restored["params"])
        opt_state = restored["opt"]
        resumed_from = latest
        log(f"[driver] resumed from step {latest}")
    start = resumed_from or 0

    losses = []
    nan_skips = 0
    straggler_events = 0
    for step in range(start, driver_cfg.total_steps):
        t0 = time.monotonic()
        batch = put_batch(get_batch(step))
        new_params, new_opt, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0

        if not np.isfinite(loss):
            nan_skips += 1
            log(f"[driver] step {step}: non-finite loss, skipping update "
                f"({nan_skips}/{driver_cfg.max_nan_skips})")
            if nan_skips > driver_cfg.max_nan_skips:
                raise RuntimeError("too many non-finite steps")
            # the step updated the state in place: it carries on from there
            params, opt_state = new_params, new_opt
            continue
        params, opt_state = new_params, new_opt
        losses.append(loss)

        if dt > driver_cfg.deadline_s:
            straggler_events += 1
            if on_straggler:
                on_straggler(step, dt)
            log(f"[driver] step {step}: straggler ({dt:.1f}s > "
                f"{driver_cfg.deadline_s}s deadline)")

        if step % driver_cfg.log_every == 0:
            log(f"[driver] step {step}: loss={loss:.4f} "
                f"gnorm={float(metrics.get('grad_norm', 0)):.3f} "
                f"({dt*1e3:.0f} ms)")

        if (step + 1) % driver_cfg.ckpt_every == 0:
            ckpt.save_async(driver_cfg.ckpt_dir, step + 1,
                            _state_tree(params, opt_state),
                            keep=driver_cfg.keep)

    ckpt.wait()
    ckpt.save(driver_cfg.ckpt_dir, driver_cfg.total_steps,
              _state_tree(params, opt_state), keep=driver_cfg.keep)
    return TrainResult(driver_cfg.total_steps, losses, nan_skips,
                       straggler_events, resumed_from)
