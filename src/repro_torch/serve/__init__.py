"""Streaming serve layer (port of repro/serve, single-device)."""

from .batcher import MicroBatcher
from .maintenance import MaintenancePool
from .registry import Servable, ServableRegistry, ServableSpec
from .segments import Segment, SegmentedIndex
from .stats import (ServingStats, occupancy_report, recall_proxy,
                    store_report)

__all__ = [
    "MaintenancePool",
    "MicroBatcher",
    "Segment",
    "SegmentedIndex",
    "Servable",
    "ServableRegistry",
    "ServableSpec",
    "ServingStats",
    "occupancy_report",
    "recall_proxy",
    "store_report",
]
