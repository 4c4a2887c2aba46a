"""Checkpoints (port of repro/checkpoint): atomic, checksummed, npz + json."""

from .checkpoint import ArraySpec, CheckpointCorruptError

__all__ = ["ArraySpec", "CheckpointCorruptError"]
