"""Ambient mesh context for in-model sharding constraints.

The port of ``repro/sharding/context.py``.  Model code is mesh-agnostic;
the sharded step factories (``runtime/steps.py``) register the mesh they
run over, so layers can name the layout the JAX package pins with
``with_sharding_constraint`` (the MoE all-to-all pattern,
``models/moe.py``).  The port's ranks are ``torch.device``s of one process
and each layer computes from gathered parameters, so a constraint has no
layout to pin: :func:`constrain` returns its input, values unchanged, as
``with_sharding_constraint`` does.

Prefer :func:`use_mesh`, which puts the previous mesh back when its block
ends; :func:`set_mesh` leaves the mesh set for the rest of the process.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional

# the JAX ``PartitionSpec.UNCONSTRAINED`` entry: the dim's layout is free
UNCONSTRAINED = "unconstrained"

_MESH: Optional[Any] = None


def set_mesh(mesh: Optional[Any]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Any]:
    return _MESH


@contextmanager
def use_mesh(mesh: Any):
    """``mesh`` is the ambient mesh inside the block, the previous one
    after it."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def constrain(x, spec, axes=("model",)):
    """``x`` itself, whatever the mesh: where the JAX package pins a layout
    (``with_sharding_constraint`` iff a registered mesh carries ``axes``),
    the port's values are the same and it has no layout to pin.  ``spec``
    must name one entry per dim of ``x`` when such a mesh is set."""
    mesh = _MESH
    if mesh is not None and all(a in mesh.axis_names for a in axes):
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec} for a {x.dim()}-dim tensor")
    return x
