"""The meshes of ranks one process drives: the serve mesh a sharded index is
served over, and the two-axis pod mesh of the independent-family index.

The port of ``repro/launch/mesh.py``.  The JAX
package serves a mesh from one process (``shard_map``, single controller),
and its tests force 8 host devices onto one CPU; the port keeps that
design: one process drives every rank, and a :class:`ServeMesh` is an
ordered tuple of ``torch.device`` ranks along one axis, ``"serve"``.  A
physical device may hold several ranks:

* on the CPU every rank is ``cpu`` (the tests use 8); on ``meta`` (the
  dry run's shapes, no memory) every rank is ``meta``;
* on a machine with one card every rank is ``cuda:0``;
* with more cards, rank ``i`` is ``cuda:((base + i) % device_count)``,
  ``base`` the index of the card asked for (``cuda`` alone: the current
  one).

:class:`PodMesh` is the ``(data, model)`` grid that
``core.distributed.build_distributed`` and its query and brute force run
over (:func:`make_test_mesh`, 2 x 4; :func:`make_production_mesh`, the
pod's 16 x 16).  Its ranks follow the same rule, rank ``(di, mi)`` taking
the place ``di * M + mi`` in the order above.  The JAX package's
``multi_pod`` mesh adds a third axis that repeats the same index on a
second pod; on one card that would only repeat the same work, so the port
has no such mesh.

Nothing here touches a device when it is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import dispatch


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """An ordered tuple of ranks along the one axis ``axis_names[0]``.
    ``shape`` maps the axis to its size, as a JAX mesh's does, so the
    placement code reads either alike."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("serve",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a serve mesh needs at least one rank")
        if len(self.axis_names) != 1:
            raise ValueError(f"a serve mesh has one axis, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    def describe(self) -> dict:
        """JSON-able: the axis, its size and each rank's device."""
        return {"axis": self.axis_names[0], "size": len(self.devices),
                "devices": [str(d) for d in self.devices]}


def _ranks(n: int, device) -> Tuple[torch.device, ...]:
    """``n`` ranks on ``device`` (resolved by ``dispatch.resolve_device``)
    in the order the module docstring sets out."""
    base = dispatch.resolve_device(device)
    if base.type in ("cpu", "meta"):
        return (base,) * n
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", (base.index + i) % count)
                 for i in range(n))


def make_serve_mesh(n_devices: Optional[int] = None, device=None,
                    axis: str = "serve") -> ServeMesh:
    """A mesh of ``n_devices`` ranks on ``device`` (``dispatch.
    resolve_device``: the card unless ``"cpu"`` is asked for; with no card
    and no ``"cpu"`` it raises -- there is no CPU fallback on a card run).
    ``n_devices`` defaults to every card, or 1 on the CPU."""
    base = dispatch.resolve_device(device)
    if n_devices is not None:
        n = int(n_devices)
    else:
        n = 1 if base.type == "cpu" else torch.cuda.device_count()
    if n < 1:
        raise ValueError(f"a serve mesh needs at least one rank, got {n}")
    return ServeMesh(devices=_ranks(n, base), axis_names=(axis,))


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """A ``(D, M)`` grid of ranks over the axes ``("data", "model")``:
    ``devices[di][mi]`` is rank ``(di, mi)``.  ``shape`` maps each axis to
    its size, as a JAX mesh's does."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "model")

    def __post_init__(self):
        if not self.devices or not self.devices[0]:
            raise ValueError("a pod mesh needs at least one rank")
        if any(len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a pod mesh's rows must be equally long")
        if len(self.axis_names) != 2:
            raise ValueError(f"a pod mesh has two axes, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}


def make_pod_mesh(shape: Tuple[int, int], device=None) -> PodMesh:
    """A ``shape`` = (D, M) grid of ranks on ``device`` (``dispatch.
    resolve_device``: the card unless ``"cpu"`` is asked for; no CPU
    fallback on a card run)."""
    d, m = (int(v) for v in shape)
    if d < 1 or m < 1:
        raise ValueError(f"a pod mesh needs at least one rank, got {shape}")
    flat = _ranks(d * m, device)
    return PodMesh(devices=tuple(flat[i * m:(i + 1) * m] for i in range(d)))


def make_test_mesh(shape: Tuple[int, int] = (2, 4), device=None) -> PodMesh:
    """The JAX package's test mesh, 2 x 4 by default."""
    return make_pod_mesh(shape, device)


def make_production_mesh(device=None) -> PodMesh:
    """The pod's 16 x 16 mesh (JAX ``make_production_mesh()``; its
    ``multi_pod`` form is not ported, see the module docstring)."""
    return make_pod_mesh((16, 16), device)
