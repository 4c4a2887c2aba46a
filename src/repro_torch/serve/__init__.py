"""Streaming serve layer (port of repro/serve, single-device)."""

from .batcher import MicroBatcher
from .faults import FaultPlan, FaultSpec, InjectedFault
from .maintenance import MaintenancePool
from .registry import Servable, ServableRegistry, ServableSpec
from .segments import Segment, SegmentedIndex
from .standby import WalStandby
from .stats import (ServingStats, occupancy_report, recall_proxy,
                    store_report)
from .wal import WriteAheadLog, read_wal

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "MaintenancePool",
    "MicroBatcher",
    "Segment",
    "SegmentedIndex",
    "Servable",
    "ServableRegistry",
    "ServableSpec",
    "ServingStats",
    "WalStandby",
    "WriteAheadLog",
    "occupancy_report",
    "read_wal",
    "recall_proxy",
    "store_report",
]
