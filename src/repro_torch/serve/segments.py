"""Segmented mutable LSH index: the streaming lifecycle over core.index.

The port of ``repro/serve/segments.py``, fp32 and unsharded:

* one mutable **delta** segment absorbs inserts through ``insert_items`` in
  fixed ``insert_chunk``-row padded chunks;
* when the delta reaches ``segment_capacity`` it is **sealed** and a fresh
  delta opens (incremental inserts keep every table valid, so sealing is
  free);
* **deletes** are tombstones in a per-segment live mask read at query time;
* **query** fans out one ``query_index_gids`` per non-empty segment -- each
  re-hashes the batch, as the JAX package's per-segment program does -- and
  merges the per-segment top-k through ``ops.merge_topk`` (K3 on the card).

Every segment shares ONE hash family, so an item's buckets do not depend
on which segment holds it, and (with no bucket overflowing) a segmented
query returns the ids one index over the live items would: segmentation is
invisible.  Device state per segment is an ``LSHIndexState`` plus a
(capacity,) gid vector and live mask; the gid -> (segment, slot) locator is
host-side.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import index as lidx
from ..core.index import IndexConfig, LSHIndexState
from ..kernels import dispatch, ops


@dataclasses.dataclass
class Segment:
    """One segment of the index (sealed or the delta)."""

    state: LSHIndexState
    gids: torch.Tensor          # (capacity,) int32 global id per slot
    live: torch.Tensor          # (capacity,) bool, False = tombstoned/empty
    n_items: int = 0            # slots used (tombstoned included)
    n_live: int = 0
    sealed: bool = False

    @property
    def capacity(self) -> int:
        return self.gids.shape[0]

    def occupancy(self) -> dict:
        cap = self.capacity
        return {
            "n_items": self.n_items,
            "n_live": self.n_live,
            "capacity": cap,
            "fill": self.n_items / cap,
            "tombstone_frac": ((self.n_items - self.n_live) / self.n_items
                               if self.n_items else 0.0),
            "sealed": self.sealed,
        }


def _segment_query_fn(cfg: IndexConfig, k: int, n_probes: int):
    """The per-segment program: query one segment, translate slots to
    global ids.  Every segment runs this same body."""

    def f(state: LSHIndexState, q: torch.Tensor, live: torch.Tensor,
          gids: torch.Tensor):
        return lidx.query_index_gids(state, cfg, q, k, gids,
                                     n_probes=n_probes, live_mask=live)

    return f


class SegmentedIndex:
    """Mutable, queryable index built from fixed-shape segments on one
    device (default: the card).

    ``family`` (alpha, b, mix) injects a hash family -- how tests hand the
    port and the JAX package the same one; otherwise it is drawn from
    ``torch.Generator().manual_seed(seed)``.
    """

    def __init__(self, cfg: IndexConfig, *, segment_capacity: int = 1024,
                 insert_chunk: int = 256, seed: int = 0, family=None,
                 device=None):
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.segment_capacity = int(segment_capacity)
        self.insert_chunk = min(int(insert_chunk), self.segment_capacity)
        if family is None:
            family = lidx.make_family(torch.Generator().manual_seed(seed),
                                      cfg)
        self.family = tuple(t.to(self.device) for t in family)
        self.segments: List[Segment] = []
        self._locator: dict = {}          # gid -> (segment index, slot)
        self._next_gid = 0
        self._lock = threading.RLock()
        self.n_rejected = 0
        self._open_segment()

    # -- lifecycle ----------------------------------------------------------

    def _open_segment(self) -> Segment:
        state = lidx.create_index(self.cfg, self.segment_capacity,
                                  family=self.family, device=self.device)
        seg = Segment(
            state=state,
            gids=torch.full((self.segment_capacity,), -1, dtype=torch.int32,
                            device=self.device),
            live=torch.zeros((self.segment_capacity,), dtype=torch.bool,
                             device=self.device))
        self.segments.append(seg)
        return seg

    @property
    def delta(self) -> Segment:
        return self.segments[-1]

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.segments)

    @property
    def n_items(self) -> int:
        return sum(s.n_items for s in self.segments)

    def _seal(self) -> None:
        """Seal the current delta (callers hold the lock) and open a fresh
        one."""
        if self.delta.n_items == 0:
            return
        self.delta.sealed = True
        self._open_segment()

    # -- mutation -----------------------------------------------------------

    def insert(self, embeddings, gids: Optional[Sequence[int]] = None
               ) -> np.ndarray:
        """Insert (m, N) embeddings; returns their global ids (int32).

        Splits across segment boundaries, sealing when the delta fills;
        every device call is one (insert_chunk, N) padded chunk.  All or
        nothing: a width mismatch or a NaN/Inf row raises ``ValueError``
        before any row lands (counted in ``n_rejected``).
        """
        emb = torch.as_tensor(embeddings, dtype=torch.float32,
                              device=self.device)
        if emb.dim() != 2 or emb.shape[1] != self.cfg.n_dims:
            self.n_rejected += emb.shape[0] if emb.dim() == 2 else 1
            raise ValueError(
                f"expected embeddings of shape (m, {self.cfg.n_dims}), "
                f"got {tuple(emb.shape)}")
        finite = torch.isfinite(emb).all(dim=1)
        if not bool(finite.all()):
            self.n_rejected += emb.shape[0]
            raise ValueError(
                f"embeddings contain NaN/Inf in {int((~finite).sum())} of "
                f"{emb.shape[0]} rows; rejecting the batch (nothing was "
                "inserted)")
        m = emb.shape[0]
        with self._lock:
            if gids is None:
                out_gids = np.arange(self._next_gid, self._next_gid + m,
                                     dtype=np.int32)
            else:
                out_gids = np.asarray(list(gids), np.int32)
                if out_gids.shape != (m,):
                    raise ValueError("gids length must match embeddings")
                if m and out_gids.min() < 0:
                    raise ValueError("gids must be >= 0 (-1 is the "
                                     "empty-slot sentinel)")
                if np.unique(out_gids).size != m:
                    raise ValueError("duplicate gids within one insert")
                dup = [g for g in out_gids.tolist() if g in self._locator]
                if dup:
                    raise ValueError(f"gids already present: {dup[:5]}")
            if m:
                self._next_gid = max(self._next_gid,
                                     int(out_gids.max()) + 1)
            gids_dev = torch.as_tensor(out_gids, device=self.device)
            pos = 0
            while pos < m:
                seg = self.delta
                room = seg.capacity - seg.n_items
                if room == 0:
                    self._seal()
                    continue
                take = min(m - pos, room, self.insert_chunk)
                chunk = emb.new_zeros((self.insert_chunk, self.cfg.n_dims))
                chunk[:take] = emb[pos:pos + take]
                seg.state = lidx.insert_items(seg.state, self.cfg, chunk,
                                              seg.n_items, take)
                sl = slice(seg.n_items, seg.n_items + take)
                seg.gids[sl] = gids_dev[pos:pos + take]
                seg.live[sl] = True
                si = len(self.segments) - 1
                for j, g in enumerate(out_gids[pos:pos + take].tolist()):
                    self._locator[g] = (si, seg.n_items + j)
                seg.n_items += take
                seg.n_live += take
                pos += take
        return out_gids

    def delete(self, gids: Sequence[int]) -> int:
        """Tombstone items by global id; returns how many were live."""
        with self._lock:
            by_seg: dict = {}
            for g in np.asarray(gids).ravel().tolist():
                loc = self._locator.get(int(g))
                if loc is not None:
                    # a set per segment: a gid repeated in one call must
                    # not count its slot twice
                    by_seg.setdefault(loc[0], set()).add(loc[1])
            n = 0
            for si, slot_set in by_seg.items():
                seg = self.segments[si]
                slots = torch.as_tensor(sorted(slot_set), dtype=torch.int64,
                                        device=self.device)
                hits = int(seg.live[slots].sum())
                if hits == 0:
                    continue
                seg.live[slots] = False
                seg.n_live -= hits
                n += hits
            return n

    def live_items(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every live item on the device: (embeddings (n_live, N),
        gids (n_live,))."""
        with self._lock:
            emb_parts, gid_parts = [], []
            for seg in self.segments:
                if seg.n_live == 0:
                    continue
                live = seg.live[:seg.n_items]
                emb_parts.append(seg.state.db[:seg.n_items][live])
                gid_parts.append(seg.gids[:seg.n_items][live])
        if not emb_parts:
            return (torch.zeros((0, self.cfg.n_dims), device=self.device),
                    torch.zeros((0,), dtype=torch.int32, device=self.device))
        return torch.cat(emb_parts), torch.cat(gid_parts)

    # -- query --------------------------------------------------------------

    def query(self, queries, k: int, n_probes: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-segment k-NN: (nq, N) -> (gids (nq, k), dists (nq, k)).

        One per-segment query per non-empty segment, merged by
        ``ops.merge_topk`` (a single segment is merged too, so tie order
        does not depend on the segment count)."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device).contiguous()
        with self._lock:
            fn = _segment_query_fn(self.cfg, k, n_probes)
            shards = [fn(s.state, q, s.live, s.gids) for s in self.segments
                      if s.n_live > 0]
        if not shards:
            return (torch.full((q.shape[0], k), -1, dtype=torch.int32,
                               device=self.device),
                    torch.full((q.shape[0], k), torch.inf,
                               device=self.device))
        g_all = torch.cat([g for g, _ in shards], dim=1)
        d_all = torch.cat([d for _, d in shards], dim=1)
        return _merged(d_all, g_all, k)

    def occupancy(self) -> List[dict]:
        return [s.occupancy() for s in self.segments]


def _merged(dists: torch.Tensor, gids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    d, g = ops.merge_topk(dists, gids, k)
    return g, d
