"""The sealed segments of a ``SegmentedIndex``, stacked on one device.

The port of ``repro/sharding/placement.py``, its single-device half: every
sealed segment's leaves live in one leading-axis tensor per leaf, so that
one gather and one scorer launch cover all of them
(:func:`repro_torch.core.distributed.query_segments_stacked`):

* ``table`` (S_cap, L, B, slots) int32, ``db`` (S_cap, cap, N) at the
  tier's dtype (fp32 rows, int8 or bf16 codes), ``gids`` (S_cap, cap)
  int32, ``live`` (S_cap, cap) bool; on a quantized tier also ``scale``
  (S_cap,) f32 and, on the host, the fp32 survivor ``pool`` (S_cap, cap,
  N);
* sealed segment ``i`` of the index (its position in ``segments``) sits in
  slot ``i``; slots ``[n_sealed, S_cap)`` are headroom and never scored;
* a sealed ``Segment``'s ``state.table``, ``state.db``, ``gids``, ``live``
  (and ``scale``, ``pool``) are views of its slot, so a tombstone written
  through the segment is what the stacked query reads, and the views are
  rebound whenever the stack is reallocated;
* S_cap grows by capacity doubling (:func:`headroom`, the JAX package's
  ``_headroom_per_dev``): a seal copies one segment into a free slot, and
  only a seal that finds no free slot restacks, so n seals restack
  O(log n) times.  :meth:`SegmentStack.rebuild` restacks a whole list of
  segments (and may shrink S_cap by the same rule).

Left out (the multi-device half): round-robin over devices, replication,
padding segments and the ``(content, live)`` fingerprint diff.  Nothing
here is replicated: the delta stays its own segment.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


def headroom(need: int, prev: int = 0) -> int:
    """Slots for ``need`` sealed segments under capacity doubling, given
    the stack's current ``prev`` slots (0: no stack yet, the JAX package's
    ``prev=None``): grow to at least twice ``prev`` when the need outgrows
    it, keep ``prev`` while the need fits, and shrink to twice the need
    only once the need falls to a quarter of ``prev``."""
    if need > prev:
        return max(need, 2 * prev)
    if need * 4 <= prev and prev > 1:
        return max(1, need * 2)
    return prev


class SegmentStack:
    """One tensor per sealed-segment leaf on ``device``, for segments of
    ``capacity`` slots under index config ``cfg``; see the module
    docstring.  ``db_dtype`` is the tier's storage dtype; ``quantized``
    adds the per-segment ``scale`` and the host survivor ``pool``."""

    def __init__(self, cfg, capacity: int, db_dtype: torch.dtype,
                 quantized: bool, device: torch.device):
        self.capacity = int(capacity)
        self.n_dims = int(cfg.n_dims)
        self.quantized = bool(quantized)
        self.device = device
        self._table_shape = (cfg.n_tables, cfg.n_buckets,
                             cfg.bucket_capacity)
        self._db_dtype = db_dtype
        self.segments: List = []          # the sealed Segments, slot order
        self._alloc(0)

    @property
    def n_sealed(self) -> int:
        return len(self.segments)

    @property
    def s_cap(self) -> int:
        return self.table.shape[0]

    def _alloc(self, s_cap: int) -> None:
        """Fresh leaves of ``s_cap`` slots, headroom empty (gids -1, dead)."""
        cap, dev = self.capacity, self.device
        self.table = torch.full((s_cap, *self._table_shape), -1,
                                dtype=torch.int32, device=dev)
        self.db = torch.zeros((s_cap, cap, self.n_dims),
                              dtype=self._db_dtype, device=dev)
        self.gids = torch.full((s_cap, cap), -1, dtype=torch.int32,
                               device=dev)
        self.live = torch.zeros((s_cap, cap), dtype=torch.bool, device=dev)
        self.scale = (torch.ones((s_cap,), dtype=torch.float32, device=dev)
                      if self.quantized else None)
        self.pool = (np.zeros((s_cap, cap, self.n_dims), np.float32)
                     if self.quantized else None)

    def _write(self, slot: int, seg, db, scale, pool) -> None:
        """Copy ``seg``'s leaves (its rows as ``db``, ``scale`` and
        ``pool``) into ``slot`` and make them views of it."""
        self.table[slot] = seg.state.table
        self.db[slot] = db
        self.gids[slot] = seg.gids
        self.live[slot] = seg.live
        if self.quantized:
            self.scale[slot] = scale
            self.pool[slot] = pool
        seg.state = dataclasses.replace(seg.state, table=self.table[slot],
                                        db=self.db[slot])
        seg.gids = self.gids[slot]
        seg.live = self.live[slot]
        if self.quantized:
            seg.scale = self.scale[slot]
            seg.pool = self.pool[slot]

    def _restack(self, segments: Sequence, s_cap: int) -> None:
        old = list(segments)
        self._alloc(s_cap)
        for slot, seg in enumerate(old):
            self._write(slot, seg, seg.state.db, seg.scale, seg.pool)
        self.segments = old

    def seal(self, seg, db: torch.Tensor, scale=None, pool=None) -> int:
        """Stack a segment that is being sealed, its rows ``db`` at the
        tier's dtype (on a quantized tier its codes, ``scale`` () f32 and
        fp32 ``pool``): the leaves go into the next free slot -- one
        segment's bytes -- after a doubling restack when none is free, and
        become the segment's.  Until the copy is done the segment is left
        as it was.  Returns the slot."""
        if db.dtype != self._db_dtype:
            raise TypeError(f"stack holds {self._db_dtype} rows, segment "
                            f"has {db.dtype}")
        slot = self.n_sealed
        if slot == self.s_cap:
            self._restack(self.segments, headroom(slot + 1, self.s_cap))
        self._write(slot, seg, db, scale, pool)
        self.segments.append(seg)
        return slot

    def rebuild(self, segments: Sequence) -> None:
        """Restack ``segments`` as the whole sealed set, in order: slot i
        is ``segments[i]``.  S_cap follows :func:`headroom`, so a set that
        fell to a quarter of the slots shrinks.  A compaction's splice
        swap calls it on the shadow index's stack, which the index then
        keeps."""
        self._restack(segments, headroom(len(segments), self.s_cap))

    def sealed(self):
        """The used slots' leaves: (table, db, gids, live, scale or None),
        each sliced to ``[:n_sealed]``."""
        s = self.n_sealed
        return (self.table[:s], self.db[:s], self.gids[:s], self.live[:s],
                None if self.scale is None else self.scale[:s])

    def nbytes(self) -> int:
        """Device bytes of every leaf at S_cap slots."""
        n = sum(t.nbytes for t in (self.table, self.db, self.gids,
                                   self.live))
        return n + (self.scale.nbytes if self.scale is not None else 0)

    def layout(self) -> dict:
        """JSON-able report (the JAX package's ``SegmentPlacement.layout``
        for one device): sealed count, slots, device and host bytes."""
        return {"n_sealed": self.n_sealed, "s_cap": self.s_cap,
                "capacity": self.capacity, "bytes": self.nbytes(),
                "pool_bytes": 0 if self.pool is None else self.pool.nbytes,
                "db_dtype": str(self._db_dtype).replace("torch.", "")}

