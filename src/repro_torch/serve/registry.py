"""Servable registry: named endpoints over segmented indexes.

The port of ``repro/serve/registry.py`` without WAL, checkpoints or meshes
(and without the ``$REPRO_STORE_DTYPE`` override: a tenant's
precision is its spec's).  A :class:`ServableSpec` is the declarative
tenant config; a :class:`Servable` is the live endpoint (embedder +
segmented index + micro-batcher + stats) on one device; the
:class:`ServableRegistry` maps names to servables.

The hash family comes from ``torch.Generator().manual_seed(spec.seed)``;
it cannot match the JAX package's ``jax.random.PRNGKey(spec.seed)`` draw,
so ``family=`` injects one (tests hand both packages the same arrays).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.index import IndexConfig
from ..embedders import embedder_names, make_embedder
from ..kernels import dispatch
from .batcher import MicroBatcher
from .maintenance import ServableMaintenance
from .segments import SegmentedIndex
from .stats import ServingStats, occupancy_report, store_report


@dataclasses.dataclass(frozen=True)
class ServableSpec:
    """Declarative tenant config (everything needed to rebuild it)."""

    name: str
    n_dims: int = 64
    p: float = 2.0                 # l_p of the p-stable family, (0, 2]
    r: float = 1.0                 # quantisation width (Eq. 5)
    n_tables: int = 8
    n_hashes: int = 4
    log2_buckets: int = 10
    bucket_capacity: int = 32
    embedder: str = "basis"        # a repro_torch.embedders name
    embedder_params: Optional[Dict[str, Any]] = None
    volume: float = 1.0
    segment_capacity: int = 1024
    insert_chunk: int = 256
    chunk_sizes: Tuple[int, ...] = (8, 32, 128)
    max_delay_ms: float = 5.0
    seed: int = 0
    # sealed-segment storage tier: "fp32" (exact, the default) | "bf16" |
    # "int8" (bounded-loss, survivor-reranked)
    precision: str = "fp32"
    # survivor-pool width m of the quantized query (0 = the default 4k;
    # ``kernels.quantize.survivor_width``)
    survivor_k: int = 0

    def __post_init__(self):
        if self.embedder not in embedder_names():
            raise ValueError(f"embedder must be one of {embedder_names()}")
        if self.precision not in dispatch.STORE_DTYPES:
            raise ValueError(
                f"precision must be one of {dispatch.STORE_DTYPES}, "
                f"got {self.precision!r}")

    def index_config(self) -> IndexConfig:
        return IndexConfig(n_dims=self.n_dims, n_tables=self.n_tables,
                           n_hashes=self.n_hashes,
                           log2_buckets=self.log2_buckets,
                           bucket_capacity=self.bucket_capacity,
                           r=self.r, p=self.p)


class Servable:
    """A live endpoint on ``device`` (default: the card; with no card and
    no explicit ``device="cpu"`` construction raises)."""

    def __init__(self, spec: ServableSpec, *, device=None, family=None):
        self.spec = spec
        self.device = dispatch.resolve_device(device)
        self.embedder = make_embedder(spec.embedder, n_dims=spec.n_dims,
                                      p=spec.p, volume=spec.volume,
                                      params=spec.embedder_params,
                                      device=self.device)
        self.stats = ServingStats()
        self.index = SegmentedIndex(spec.index_config(),
                                    segment_capacity=spec.segment_capacity,
                                    insert_chunk=spec.insert_chunk,
                                    seed=spec.seed, family=family,
                                    precision=spec.precision,
                                    survivor_k=spec.survivor_k,
                                    device=self.device)
        # the tenant's maintenance handle (seal, compact); the
        # MaintenancePool is its background caller
        self.maintenance = ServableMaintenance(self)
        self.batcher = MicroBatcher(self._raw_query,
                                    chunk_sizes=spec.chunk_sizes,
                                    max_delay_ms=spec.max_delay_ms,
                                    on_batch=self.stats.record_batch)

    def embed(self, fvals) -> torch.Tensor:
        """Function samples (B, len(nodes())) -> (B, n_dims) embeddings on
        the device, through the padded ingest palette."""
        return self.embedder.embed_batched(
            fvals, batch_size=max(self.spec.chunk_sizes))

    def nodes(self) -> np.ndarray:
        return self.embedder.nodes()

    def insert(self, embeddings, gids=None) -> np.ndarray:
        before = self.index.n_rejected
        try:
            out = self.index.insert(embeddings, gids=gids)
        except ValueError:
            self.stats.record_rejected(self.index.n_rejected - before)
            raise
        self.stats.record_insert(len(out))
        return out

    def delete(self, gids) -> int:
        n = self.index.delete(gids)
        self.stats.record_delete(n)
        return n

    def compact(self) -> int:
        """Deprecated: use ``servable.maintenance.compact()``."""
        warnings.warn(
            "Servable.compact() is deprecated; compact through the "
            "maintenance plane (servable.maintenance.compact())",
            DeprecationWarning, stacklevel=2)
        return self.maintenance.compact()

    def _raw_query(self, queries, k: int, n_probes: int):
        g, d = self.index.query(queries, k, n_probes=n_probes)
        return g.cpu().numpy(), d.cpu().numpy()

    def submit_query(self, queries, k: int, n_probes: int = 1):
        """Admission-queue path: a Future of (gids, dists) numpy arrays."""
        return self.batcher.submit(queries, k, n_probes)

    def query(self, queries, k: int, n_probes: int = 1):
        """Synchronous path, through the same padded batches."""
        return self.batcher.query(queries, k, n_probes)

    def report(self) -> dict:
        occ = occupancy_report(self.index)
        occ.pop("segments")
        return {"spec": dataclasses.asdict(self.spec),
                "device": str(self.device),
                "embedder": self.embedder.describe(),
                "stats": self.stats.snapshot(),
                "batcher": {"unique_shapes": self.batcher.unique_shapes(),
                            "n_batches": self.batcher.n_batches,
                            "n_requests": self.batcher.n_requests},
                "occupancy": occ,
                "store": store_report(self.index)}


class ServableRegistry:
    """Name -> Servable map; every tenant lives on ``device``."""

    def __init__(self, *, device=None):
        self.device = dispatch.resolve_device(device)
        self._servables: Dict[str, Servable] = {}

    def register(self, spec: ServableSpec, family=None) -> Servable:
        if spec.name in self._servables:
            raise ValueError(f"servable {spec.name!r} already registered")
        sv = Servable(spec, device=self.device, family=family)
        self._servables[spec.name] = sv
        return sv

    def get(self, name: str) -> Servable:
        try:
            return self._servables[name]
        except KeyError:
            raise KeyError(f"no servable {name!r}; have {self.names()}")

    def names(self) -> List[str]:
        return sorted(self._servables)

    def report(self) -> dict:
        return {name: sv.report() for name, sv in
                sorted(self._servables.items())}
