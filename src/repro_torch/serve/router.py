"""Replica-aware query routing: which replica answers this micro-batch.

The port of ``repro/serve/router.py`` (numpy and the stdlib only).  The
placement (``sharding/placement.py``) may hold a hot sealed segment on
several ranks (replication factor > 1).  Replicas are bit-equal copies, so
any of them can answer; the router picks, per micro-batch, exactly one
replica of every sealed segment so that per-rank work evens out, and tells
the telemetry which rank served each segment:

* an unreplicated segment always runs on its only holder;
* a replicated one goes to its **least-loaded holder**, counting the load
  carried over from earlier batches and the load routed so far in this
  batch (ties to the lowest rank), which with even load is round robin over
  the replica set;
* the delta is scored on rank 0 (``core/distributed.py``), so the router
  only counts it there.

Deterministic: the same placement and batch sequence give the same routes,
so replicated answers are reproducible and tests assert bit equality.

``auto_factors`` turns ``ServingStats.shard_balance``'s per-segment win
counts into replication factors (win share over fair share, clipped to [1,
n_dev]): the ``replication="auto"`` policy applies it at each compaction.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """One micro-batch's replica selection.

    ``active``: (n_dev * per_dev,) bool in rank-stripe order, the
    ``active`` input of ``core.distributed.query_segments_sharded``;
    ``dev_of``: sealed-segment position -> the rank that serves it this
    batch; ``per_device_active``: instances each rank serves this batch (the
    delta counted on rank 0), fed to ``ServingStats.record_fanout``'s
    ``dev_load``."""

    active: np.ndarray
    dev_of: Dict[int, int]
    per_device_active: List[int]


class QueryRouter:
    """Per-placement replica selector with a persistent load ledger.

    Built from a placement's ``layout()`` (``n_dev``, ``per_dev``,
    ``n_sealed``, ``assignment``), so it holds no tensors; ``per_dev`` is
    the placement's slot stride, headroom included, so the slot math here
    (``d * per_dev + j``) and the query's active mask agree."""

    def __init__(self, layout: dict, tenant: str = "default",
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        self.tenant = tenant
        self.metrics = obs_metrics.registry() if metrics is None else metrics
        self.n_dev = int(layout["n_dev"])
        self.per_dev = int(layout["per_dev"])
        self.n_sealed = int(layout["n_sealed"])
        self.assignment = [list(a) for a in layout["assignment"]]
        # _slot[i][d]: the active-mask slot of segment i's replica on rank d
        self._slot: Dict[int, Dict[int, int]] = {i: {} for i in
                                                 range(self.n_sealed)}
        for d, block in enumerate(self.assignment):
            for j, seg in enumerate(block):
                self._slot[seg][d] = d * self.per_dev + j
        self._load = np.zeros((self.n_dev,), np.int64)
        self._lock = threading.Lock()

    def route(self) -> RoutePlan:
        """Pick one replica per sealed segment for the next micro-batch,
        and publish each rank's cumulative load (``router_device_load``)."""
        active = np.zeros((self.n_dev * self.per_dev,), bool)
        dev_of: Dict[int, int] = {}
        with self._lock:
            batch = np.zeros((self.n_dev,), np.int64)
            batch[0] += 1                    # the delta serves on rank 0
            # the fixed load first, the choices second, so a replicated
            # segment sees the totals it balances against
            multi = []
            for seg, holders in self._slot.items():
                if len(holders) == 1:
                    (d, slot), = holders.items()
                    active[slot] = True
                    dev_of[seg] = d
                    batch[d] += 1
                elif holders:
                    multi.append(seg)
            for seg in multi:
                holders = self._slot[seg]
                d = min(holders, key=lambda d: (self._load[d] + batch[d], d))
                active[holders[d]] = True
                dev_of[seg] = d
                batch[d] += 1
            self._load += batch
            per_dev_active = batch.tolist()
            load = self._load.tolist()
        for d, v in enumerate(load):
            self.metrics.set("router_device_load", float(v),
                             tenant=self.tenant, device=str(d))
        return RoutePlan(active=active, dev_of=dev_of,
                         per_device_active=per_dev_active)

    def device_load(self) -> List[int]:
        """Instances routed to each rank so far."""
        with self._lock:
            return self._load.tolist()


def auto_factors(seg_wins: Sequence[int], n_dev: int,
                 max_factor: Optional[int] = None) -> List[int]:
    """Replication factors from merge-win telemetry (the ``auto`` policy).

    ``seg_wins[i]``: sealed segment i's recent top-k wins
    (``shard_balance()["per_segment_wins"]`` less the delta's trailing
    slot).  A segment winning f times its fair share gets f replicas,
    clipped to [1, min(n_dev, max_factor)]; even traffic stays at factor 1,
    and no traffic at all gives factor 1 everywhere."""
    wins = np.asarray(list(seg_wins), np.float64)
    cap = n_dev if max_factor is None else min(n_dev, int(max_factor))
    if wins.size == 0 or wins.sum() <= 0:
        return [1] * wins.size
    fair = wins.sum() / wins.size
    return [int(np.clip(round(w / fair), 1, cap)) for w in wins]
