"""Streaming serve layer (port of repro/serve).

  segments    -- SegmentedIndex: delta / sealed segments, the stacked query,
                 shard(mesh) for the sharded one
  router      -- QueryRouter / RoutePlan / auto_factors: which replica
                 answers a micro-batch
  batcher     -- MicroBatcher: deadline-driven coalescing over a chunk
                 palette; a wall-clock pump thread (``start`` / ``stop``)
  stats       -- ServingStats, recall_proxy, occupancy and store reports
  registry    -- ServableSpec / Servable / ServableRegistry: named tenants,
                 snapshots, WAL recovery, the wire lifecycle
                 (``log_lifecycle`` / ``unregister``)
  wal         -- WriteAheadLog / read_wal: the JAX package's log format
  maintenance -- IndexMaintenance / ServableMaintenance / MaintenancePool:
                 seal, compact and set_replication off the query path
  standby     -- WalStandby: WAL-shipping warm standby
  faults      -- FaultPlan / InjectedFault: named crash points
  protocol    -- newline-delimited JSON frames and backpressure codes
  frontend    -- Frontend / RequestGate / run_server: the asyncio server
                 (admission control, tenant lifecycle, graceful drain);
                 ``launch/serve --listen`` runs it; BackgroundServer
                 serves it from a thread
  client      -- FrontendClient / wait_ready: the blocking client
"""

from .batcher import MicroBatcher
from .client import FrontendClient, FrontendError, wait_ready
from .faults import FaultPlan, FaultSpec, InjectedFault
from .frontend import BackgroundServer, Frontend, RequestGate, run_server
from .maintenance import (IndexMaintenance, MaintenanceJob, MaintenancePool,
                          ServableMaintenance)
from .registry import Servable, ServableRegistry, ServableSpec
from .router import QueryRouter, RoutePlan, auto_factors
from .segments import Segment, SegmentedIndex
from .standby import WalStandby
from .stats import (ServingStats, occupancy_report, recall_proxy,
                    store_report)
from .wal import WriteAheadLog, read_wal

__all__ = [
    "BackgroundServer",
    "FaultPlan",
    "FaultSpec",
    "Frontend",
    "FrontendClient",
    "FrontendError",
    "IndexMaintenance",
    "InjectedFault",
    "MaintenanceJob",
    "MaintenancePool",
    "MicroBatcher",
    "QueryRouter",
    "RequestGate",
    "RoutePlan",
    "Segment",
    "SegmentedIndex",
    "Servable",
    "ServableMaintenance",
    "ServableRegistry",
    "ServableSpec",
    "ServingStats",
    "WalStandby",
    "WriteAheadLog",
    "auto_factors",
    "occupancy_report",
    "read_wal",
    "recall_proxy",
    "run_server",
    "store_report",
    "wait_ready",
]
