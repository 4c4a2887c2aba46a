"""Deterministic synthetic data pipeline (host-sharded, prefetched).

Sequences are sampled from a fixed random bigram chain (a pure function of the
seed), so models have real structure to learn -- training loss decreases and
the end-to-end example is meaningful -- while remaining fully reproducible and
offline.  Per-host sharding slices the global batch by process index; a
background thread keeps ``prefetch`` batches ahead.

The port's own copy of ``repro/data/pipeline.py``, numpy only: the same
seed, step and process index give the same batch, bit for bit.  Its
prefetch thread, unlike the JAX package's (which loops for the life of
the process), stops: :meth:`SyntheticPipeline.close` (or leaving a ``with``
block) ends it and joins it.  ``launch/train.py`` reads its batches from
it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig

_POLL_S = 0.05     # how often a blocked put / get looks for close()


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
    """get_batch(step) is a pure function of (seed, step, process) -- restart
    at step k reproduces the identical stream (fault-tolerance requirement)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.pidx = process_index
        self.pcount = process_count
        assert shape.global_batch % process_count == 0 or shape.global_batch == 1
        self.local_batch = max(shape.global_batch // process_count, 1)
        self.lm = BigramLM(cfg.vocab_size, seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.pidx)
        b, s = self.local_batch, self.shape.seq_len
        batch = {"tokens": self.lm.sample(rng, b, s)}
        if self.cfg.family == "encdec":   # the audio stub's frames, one a token
            batch["frames"] = rng.standard_normal(
                (b, s, self.cfg.d_model)).astype(np.float32) * 0.1
        if self.cfg.modality == "vision":
            batch["patches"] = rng.standard_normal(
                (b, self.cfg.frontend_len, self.cfg.d_model)
            ).astype(np.float32) * 0.1
        return batch

    # -- background prefetch ------------------------------------------------
    def start(self, first_step: int = 0):
        """Start the prefetch thread at ``first_step`` (it runs until
        :meth:`close`)."""
        if self._thread is not None:
            raise RuntimeError("the prefetch thread is already started")
        self._stop.clear()

        def worker():
            step = first_step
            while not self._stop.is_set():
                item = (step, self.get_batch(step))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="pipeline-prefetch")
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The prefetched batches in step order, until :meth:`close`."""
        while not self._stop.is_set():
            try:
                _, batch = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            yield batch

    def close(self, timeout: float = 10.0) -> None:
        """Stop the prefetch thread and join it (at most ``timeout``
        seconds); raises if it is still alive after that."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("the prefetch thread did not stop")
        while True:                     # drop what it had queued
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
