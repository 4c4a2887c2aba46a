"""Optimisers."""
