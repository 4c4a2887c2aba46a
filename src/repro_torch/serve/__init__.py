"""Streaming serve layer (port of repro/serve, fp32 and single-device)."""

from .batcher import MicroBatcher
from .registry import Servable, ServableRegistry, ServableSpec
from .segments import Segment, SegmentedIndex
from .stats import ServingStats, occupancy_report, recall_proxy

__all__ = [
    "MicroBatcher",
    "Segment",
    "SegmentedIndex",
    "Servable",
    "ServableRegistry",
    "ServableSpec",
    "ServingStats",
    "occupancy_report",
    "recall_proxy",
]
