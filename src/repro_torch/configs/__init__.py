"""Architecture configs (one per assigned arch) + input-shape registry."""
from .base import SHAPES, ArchConfig, ShapeConfig
from .registry import ARCH_IDS, get_config, smoke_config
