"""QMCEmbedder: (quasi-)Monte Carlo node-sampling embedding (Sec. 3.2,
Eq. 6), the port of ``repro/embedders/qmc.py``.

T(f) = (V/N)^(1/p) * (f(x_1), ..., f(x_N)) with x_i from a shared node
set: a low-discrepancy sequence (Sobol / Halton) or i.i.d. uniform nodes.
Works for any p >= 1: the construction the paper uses whenever p != 2.

The embed is one scale multiply on the tenant's device (the nodes do the
work at sample time), so it has no kernel, as in the JAX package, and it
is bit-equal to the JAX package's embed on the same input.  ``"mc"``
nodes are drawn from a CPU ``torch.Generator`` seeded with ``seed``; they
cannot equal the JAX package's ``jax.random`` nodes, so a caller that
needs those carries them across with ``convert.qmc_nodes_from_numpy``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import montecarlo
from .base import FunctionEmbedder, register_embedder

SEQUENCES = ("sobol", "halton", "mc")


@register_embedder("qmc")
class QMCEmbedder(FunctionEmbedder):
    """(Q)MC node sampling: (B, N) values at the node set -> (B, N).

    ``sequence`` is ``"sobol"`` (default), ``"halton"`` or ``"mc"``;
    ``skip`` leading low-discrepancy points are discarded; ``seed`` draws
    the ``"mc"`` nodes.
    """

    def __init__(self, n_dims: int, p: float = 2.0, volume: float = 1.0,
                 interval: Tuple[float, float] = (0.0, 1.0),
                 sequence: str = "sobol", skip: int = 64, seed: int = 0,
                 device=None):
        super().__init__(n_dims, p, interval=interval, volume=volume,
                         device=device)
        if sequence not in SEQUENCES:
            raise ValueError(
                f"unknown sequence {sequence!r}; want one of {SEQUENCES}")
        self.sequence = sequence
        self.skip = int(skip)
        self.seed = int(seed)
        if sequence == "mc":
            pts = montecarlo.mc_nodes(torch.Generator().manual_seed(self.seed),
                                      self.n_dims, 1, self.interval,
                                      device="cpu")
        else:
            pts = montecarlo.qmc_nodes(self.n_dims, 1, self.interval,
                                       sequence, skip=self.skip, device="cpu")
        self._nodes = pts[:, 0].numpy()

    def nodes(self) -> np.ndarray:
        return self._nodes

    def params(self) -> dict:
        return {"interval": list(self.interval), "sequence": self.sequence,
                "skip": self.skip, "seed": self.seed}

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        return montecarlo.mc_embedding(x, self.volume, p=self.p)
