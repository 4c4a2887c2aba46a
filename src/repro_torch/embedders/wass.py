"""WassersteinEmbedder: distributions -> R^N via clipped quantile
functions, the port of ``repro/embedders/wass.py``.

Paper Sec. 2.2 / Remark 1: for 1-D distributions with d(x, y) = |x - y|,
W^p(f, g) = ||F^{-1} - G^{-1}||_{L^p([0,1])}, so hashing W^p reduces to
hashing inverse CDFs with the function-space L^p machinery.  The inverse
CDF is sampled at N Sobol quantile levels on [delta, 1 - delta] (delta =
1e-3, paper footnote 1) and MC-embedded with volume 1 - 2 delta.

* :meth:`embed` takes raw draws ``(B, m)`` (any m, unsorted ok): the step
  quantile through ``core.wasserstein.empirical_icdf``, the serve tenant's
  ingest path.  On the card that is ``torch.sort``, a gather and a scale
  multiply: the JAX package has no kernel here either.  Bit-equal to the
  JAX package's embed on the same input.
* :meth:`embed_gaussian` takes ``(mu, sigma)`` batches: the exact Gaussian
  quantile (``ndtri``), for oracles with a closed-form W2.

Both land in one embedding space, so one index serves both input forms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import montecarlo, wasserstein
from .base import FunctionEmbedder, register_embedder


@register_embedder("wasserstein")
class WassersteinEmbedder(FunctionEmbedder):
    """Clipped quantile embedding: samples (B, m) -> (B, N).

    ``p`` is the Wasserstein order; ``volume`` is ignored (it is the
    clipped interval's measure 1 - 2 clip); ``clip`` in (0, 0.5);
    ``sequence`` the quantile levels' sequence (``"sobol"`` /
    ``"halton"``).
    """

    def __init__(self, n_dims: int, p: float = 2.0, volume: float = 1.0,
                 clip: float = wasserstein.CLIP, sequence: str = "sobol",
                 device=None):
        del volume  # derived: the clipped interval's measure
        clip = float(clip)
        if not 0.0 < clip < 0.5:
            raise ValueError(f"clip must be in (0, 0.5), got {clip}")
        u, vol = wasserstein.icdf_nodes_qmc(n_dims, clip, sequence,
                                            device="cpu")
        super().__init__(n_dims, p, interval=(clip, 1.0 - clip), volume=vol,
                         device=device)
        self.clip = clip
        self.sequence = sequence
        self._u = u.to(self.device)

    def nodes(self) -> np.ndarray:
        """The quantile levels u_1..u_N in [clip, 1 - clip]."""
        return self._u.cpu().numpy()

    def params(self) -> dict:
        return {"clip": self.clip, "sequence": self.sequence}

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        vals = wasserstein.empirical_icdf(x, self._u)
        return montecarlo.mc_embedding(vals, self.volume, p=self.p)

    def embed_gaussian(self, mu, sigma) -> torch.Tensor:
        """Exact-quantile embedding of N(mu, sigma^2) batches: (...,) ->
        (..., N) on the device."""
        mu = torch.as_tensor(mu, dtype=torch.float32, device=self.device)
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=self.device)
        vals = wasserstein.gaussian_icdf(self._u, mu[..., None],
                                         sigma[..., None])
        return montecarlo.mc_embedding(vals, self.volume, p=self.p)
