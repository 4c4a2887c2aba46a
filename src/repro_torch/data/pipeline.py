"""Deterministic synthetic data pipeline.

Sequences are sampled from a fixed random bigram chain (a pure function of the
seed), so models have real structure to learn -- training loss decreases and
the end-to-end example is meaningful -- while remaining fully reproducible and
offline.

The port's own copy of ``repro/data/pipeline.py``, numpy only: the same
seed gives the same batches as its process 0, bit for bit.  The port has
no sharded step yet, so it keeps neither the per-host slicing nor the
background prefetch thread.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


class BigramLM:
    """Fixed random bigram transition table over the vocab."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 32):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.branch = branch
        # each token can transition to `branch` successors, uniform
        self.table = rng.integers(0, vocab_size, size=(vocab_size, branch),
                                  dtype=np.int32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, self.branch, size=(batch, seq))
        for t in range(1, seq):
            toks[:, t] = self.table[toks[:, t - 1], choices[:, t]]
        return toks


class SyntheticPipeline:
    """get_batch(step) is a pure function of (seed, step) -- restart at step
    k reproduces the identical stream (fault-tolerance requirement)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.lm = BigramLM(cfg.vocab_size, seed)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        # the JAX package's seed with its process index 0
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 65_537)
        b, s = max(self.shape.global_batch, 1), self.shape.seq_len
        batch = {"tokens": self.lm.sample(rng, b, s)}
        if self.cfg.family == "encdec":   # the audio stub's frames, one a token
            batch["frames"] = rng.standard_normal(
                (b, s, self.cfg.d_model)).astype(np.float32) * 0.1
        if self.cfg.modality == "vision":
            batch["patches"] = rng.standard_normal(
                (b, self.cfg.frontend_len, self.cfg.d_model)
            ).astype(np.float32) * 0.1
        return batch
