"""Placement of the sealed segments (port of repro/sharding, one device)."""
