"""The serve mesh: the ranks one process serves a sharded index over.

The port of ``repro/launch/mesh.py``'s ``make_serve_mesh``.  The JAX
package serves a mesh from one process (``shard_map``, single controller),
and its tests force 8 host devices onto one CPU; the port keeps that
design: one process drives every rank, and a :class:`ServeMesh` is an
ordered tuple of ``torch.device`` ranks along one axis, ``"serve"``.  A
physical device may hold several ranks:

* on the CPU every rank is ``cpu`` (the tests use 8);
* on a machine with one card every rank is ``cuda:0``;
* with more cards, rank ``i`` is ``cuda:((base + i) % device_count)``,
  ``base`` the index of the card asked for (``cuda`` alone: the current
  one).

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


def make_serve_mesh(n_devices: Optional[int] = None, device=None,
                    axis: str = "serve") -> ServeMesh:
    """A mesh of ``n_devices`` ranks on ``device`` (``dispatch.
    resolve_device``: the card unless ``"cpu"`` is asked for; with no card
    and no ``"cpu"`` it raises -- there is no CPU fallback on a card run).
    ``n_devices`` defaults to every card, or 1 on the CPU."""
    base = dispatch.resolve_device(device)
    if base.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        ranks = (base,) * n
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        ranks = tuple(torch.device("cuda", (base.index + i) % count)
                      for i in range(n))
    if n < 1:
        raise ValueError(f"a serve mesh needs at least one rank, got {n}")
    return ServeMesh(devices=ranks, axis_names=(axis,))
