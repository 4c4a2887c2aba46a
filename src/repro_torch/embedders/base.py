"""FunctionEmbedder protocol + name registry (port of repro/embedders/base).

An embedder maps batched function data (values at its shared node set) to
fixed-width R^N embeddings whose l^p geometry approximates the function-
space metric.  ``embed`` is batched ``(B, in_width) -> (B, n_dims)`` on the
embedder's device; ``embed_batched`` tiles any B into fixed ``batch_size``
chunks (tail zero-padded, sliced off), so the kernels see the palette's
shapes, not the arrival sizes.  ``params()`` returns JSON-able constructor
kwargs that ``make_embedder`` round-trips.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import dispatch


class FunctionEmbedder(abc.ABC):
    """Fixed-output-width, batched function embedder on one device."""

    #: registry name; set by :func:`register_embedder`.
    name: str = "?"

    def __init__(self, n_dims: int, p: float = 2.0,
                 interval: Tuple[float, float] = (0.0, 1.0),
                 volume: float = 1.0, device=None):
        self.n_dims = int(n_dims)
        self.p = float(p)
        self.interval = (float(interval[0]), float(interval[1]))
        self.volume = float(volume)
        self.device = dispatch.resolve_device(device)

    @abc.abstractmethod
    def nodes(self) -> np.ndarray:
        """Where to sample functions for :meth:`embed`."""

    @abc.abstractmethod
    def params(self) -> dict:
        """JSON-able constructor kwargs beyond n_dims/p/volume."""

    @abc.abstractmethod
    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in_width) f32 on ``self.device`` -> (B, n_dims) f32."""

    def embed(self, x) -> torch.Tensor:
        """Batched embedding: (B, in_width) -> (B, n_dims) on the device."""
        return self._embed(torch.as_tensor(x, dtype=torch.float32,
                                           device=self.device).contiguous())

    def embed_batched(self, x, batch_size: int = 128) -> torch.Tensor:
        """Embed any number of rows through fixed ``batch_size`` chunks;
        every chunk, a short tail included, is zero-padded to
        ``batch_size`` (rows are independent) and the padding sliced off."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        out = []
        for start in range(0, max(x.shape[0], 1), batch_size):
            chunk = x[start:start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,
                                                           x.shape[1]))])
            e = self.embed(chunk)
            out.append(e[:batch_size - pad])
        return torch.cat(out)

    def describe(self) -> dict:
        return {"name": self.name, "n_dims": self.n_dims, "p": self.p,
                "interval": list(self.interval), "volume": self.volume,
                "params": self.params()}


_FACTORIES: Dict[str, Callable[..., FunctionEmbedder]] = {}


def register_embedder(name: str):
    """Class decorator: register a FunctionEmbedder under ``name``."""

    def deco(cls):
        cls.name = name
        _FACTORIES[name] = cls
        return cls

    return deco


def embedder_names() -> Tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


def make_embedder(name: str, n_dims: int, p: float = 2.0,
                  volume: float = 1.0,
                  params: Optional[Dict[str, Any]] = None,
                  device=None) -> FunctionEmbedder:
    """Build the embedder registered under ``name`` on ``device``."""
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown embedder {name!r}; have {embedder_names()}") from None
    return factory(n_dims=n_dims, p=p, volume=volume, device=device,
                   **dict(params or {}))
