"""Segmented mutable LSH index: the streaming lifecycle over core.index.

The port of ``repro/serve/segments.py`` on one device:

* one mutable **delta** segment absorbs inserts through ``insert_items`` in
  fixed ``insert_chunk``-row padded chunks;
* when the delta reaches ``segment_capacity`` it is **sealed** and a fresh
  delta opens (incremental inserts keep every table valid, so sealing is
  free); a seal copies the segment into a slot of the **stack**
  (``repro_torch.sharding.placement.SegmentStack``: one tensor per leaf
  over every sealed segment, grown by capacity doubling), and the sealed
  segment's tensors become views of that slot;
* **deletes** are tombstones in a per-segment live mask read at query time
  (through the views, in the stack);
* **compaction** (``index.maintenance.compact()``) re-packs the live items
  into fresh segments in three phases -- freeze (locked), a shadow build
  with no lock while queries and writes go on, swap (locked) -- and the
  index adopts the shadow's stack, whose slots hold only the items live
  at the freeze (see :meth:`SegmentedIndex._maint_compact`);
* **query** runs ``core.distributed.query_segments_stacked``: the batch is
  hashed and probed once (one K1 launch), one gather covers the stacked
  tables, one K2 launch scores every sealed segment and one more the
  delta, and one ``ops.merge_topk`` (K3) takes the top k -- a number of
  kernels that does not grow with the segment count.  Its answer is, bit
  for bit, that of the per-segment fan-out the JAX package's unsharded
  path runs (one ``query_index_gids`` a segment, each re-hashing the
  batch, merged by K3), which stays here as ``_query_fanout`` for the
  tests and the chip smoke's parity phase to hold it against;
* the **precision tier** (``precision="bf16"`` or ``"int8"``): a seal
  encodes the delta's rows into codes + one dequant scale, stacked, and
  moves the exact fp32 rows to the stack's host-side survivor pool.  A
  query scores every sealed segment in code space in one K5 launch (each
  segment's rows against its own scale) for its top ``m`` survivors,
  merges them (K3), gathers their fp32 rows from the pool and rescores
  them exactly (K6 + K3).  The delta stays fp32, and an fp32 tenant
  builds no codes, scales or pools (invariant 10);
* **durability**: with a write-ahead log attached (``attach_wal``) every
  mutation -- insert, delete, an explicit seal, a compaction's freeze, a
  replication policy -- is framed and appended before it is applied, and
  ``replay`` / ``apply_records`` re-apply a log idempotently (duplicate
  gids drop and are counted; delete, seal and compact are idempotent), so
  snapshot + WAL tail answers as the run that never crashed (invariant 7);
* a query row holding a NaN or an infinity answers ``(-1, +inf)`` in every
  slot on either device: its NaN and +-inf entries are zeroed before any
  kernel runs and its answer blanked after, so K1-K3 never see them;
* **telemetry** (``repro_torch.obs``), as the JAX package's: ``seal`` and
  ``compact`` spans, the ``store_bytes_per_item`` gauge at each seal and
  swap (a compaction's shadow publishes as tenant "default", as the JAX
  package's does), ``rerank_survivor_frac`` from the host survivor gids, and
  :meth:`SegmentedIndex.fanout_telemetry`, which attributes a merged
  answer's host gids to segments (one lookup through a gid -> segment
  array kept beside the locator) and feeds the ``on_fanout`` hook.  Inside
  a sampled trace with deep tracing on, an fp32 query runs the **staged**
  form of the stacked query: the same function, each of its stages
  (``hash``, ``probe``, ``gather``, ``rerank``, ``merge``) under a span
  that ends with a device sync, so stage times are real.  Nothing of it
  syncs, or adds an op, at sample 0;
* **shard(mesh)** serves the index over a ``launch.mesh.ServeMesh``: the
  live sealed segments are placed round robin over its ranks
  (``sharding.placement.place_segments``: one block of instances per rank,
  on the rank's device), and a query runs
  ``core.distributed.query_segments_sharded`` (hash and probe once, one
  gather, one K2/K5 launch and one K3 a rank, the delta on rank 0, the
  fan-in by ``ops.merge_topk_unique``), bit for bit the stacked query.
  The placement is rebuilt lazily on the first query after a mutation of
  the sealed set, as a diff of the last one (a seal moves one segment's
  bytes; ``placement_replaced_bytes_total`` against
  ``placement_restack_bytes_total``), and only re-takes the delta after a
  delta-only mutation; ``refresh_placement`` pays the rebuild off the
  query path.  ``maintenance.set_replication`` (factors per sealed
  segment, an int, or None) puts hot segments on several ranks; a
  ``serve.router.QueryRouter`` then activates one replica a segment per
  micro-batch.  ``unshard()`` returns to the stack, which stays current
  throughout;

Every segment shares ONE hash family, so an item's buckets do not depend
on which segment holds it, and (with no bucket overflowing) a segmented
query returns the ids one index over the live items would: segmentation is
invisible.  Device state per segment is an ``LSHIndexState`` plus a
(capacity,) gid vector and live mask; the gid -> (segment, slot) locator is
host-side, and sealed segment ``i`` sits in stack slot ``i``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import warnings
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import distributed
from ..core import index as lidx
from ..core.index import IndexConfig, LSHIndexState
from ..kernels import dispatch, ops, quantize
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..sharding import placement as seg_placement
from ..sharding.placement import SegmentStack
from . import faults, wal as walmod
from .router import QueryRouter


@dataclasses.dataclass
class Segment:
    """One segment of the index (sealed or the delta)."""

    state: LSHIndexState
    gids: torch.Tensor          # (capacity,) int32 global id per slot
    live: torch.Tensor          # (capacity,) bool, False = tombstoned/empty
    n_items: int = 0            # slots used (tombstoned included)
    n_live: int = 0
    sealed: bool = False
    # Precision tier (sealed bf16/int8 segments only; None on fp32 tenants
    # and on the delta, which stays fp32 until sealed; in an index, views
    # of the stack's slot):
    scale: Optional[torch.Tensor] = None   # () f32 dequant scale
    pool: Optional[np.ndarray] = None      # (capacity, N) f32 survivor pool
    # placement-diff fingerprints (``placement_key``): cached on sealed
    # segments, the live half dropped when a tombstone lands
    _content_key: Optional[tuple] = dataclasses.field(default=None,
                                                      repr=False)
    _live_key: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def capacity(self) -> int:
        return self.gids.shape[0]

    def placement_key(self) -> tuple:
        """``(content, live)`` fingerprint for placement diffing.  A sealed
        segment's rows follow from its ordered gids (one family for every
        segment, an item's embedding never changes), so ``(n_items,
        crc32(gids))`` names its content, and the live mask has a crc of
        its own, so a delete in a sealed segment diffs as a mask-row
        rewrite.  An unsealed segment gets a key that changes with every
        mutation and is never cached."""
        if not self.sealed:
            k = ("unsealed", id(self), int(self.n_items), int(self.n_live))
            return (k, k)
        if self._content_key is None:
            self._content_key = (int(self.n_items), zlib.crc32(
                self.gids.cpu().numpy().tobytes()))
        if self._live_key is None:
            self._live_key = zlib.crc32(self.live.cpu().numpy().tobytes())
        return (self._content_key, self._live_key)

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


class SegmentedIndex:
    """Mutable, queryable index built from fixed-shape segments on one
    device (default: the card), its queries served there or, after
    :meth:`shard`, over a serve mesh.

    ``family`` (alpha, b, mix) injects a hash family -- how tests hand the
    port and the JAX package the same one; otherwise it is drawn from
    ``torch.Generator().manual_seed(seed)``.  ``precision`` is the sealed
    segments' storage tier (``dispatch.STORE_DTYPES``); ``survivor_k`` the
    quantized query's survivor-pool width (0: the default 4k,
    ``quantize.survivor_width``).  ``tenant`` labels spans and metrics;
    ``on_fanout(seg_wins)`` is the hook :meth:`fanout_telemetry` feeds
    (``ServingStats.record_fanout``).
    """

    def __init__(self, cfg: IndexConfig, *, segment_capacity: int = 1024,
                 insert_chunk: int = 256, seed: int = 0, family=None,
                 precision: str = "fp32", survivor_k: int = 0, device=None,
                 tenant: str = "default", on_fanout=None):
        if precision not in dispatch.STORE_DTYPES:
            raise ValueError(f"unknown precision {precision!r}; want one "
                             f"of {dispatch.STORE_DTYPES}")
        self.cfg = cfg
        self.tenant = tenant
        self._on_fanout = on_fanout
        self.precision = precision
        self.survivor_k = int(survivor_k)
        # share of survivor slots holding a gid in the last quantized query
        # (the JAX package's rerank_survivor_frac gauge)
        self.rerank_survivor_frac: Optional[float] = None
        self.device = dispatch.resolve_device(device)
        self.segment_capacity = int(segment_capacity)
        self.insert_chunk = min(int(insert_chunk), self.segment_capacity)
        if family is None:
            family = lidx.make_family(torch.Generator().manual_seed(seed),
                                      cfg)
        self.family = tuple(t.to(self.device) for t in family)
        self.segments: List[Segment] = []
        # the sealed segments' leaves, slot i = segments[i]
        self._stack = SegmentStack(cfg, self.segment_capacity,
                                   quantize.storage_dtype(precision),
                                   precision != "fp32", self.device)
        self._locator: dict = {}          # gid -> (segment index, slot)
        # gid -> segment index (-1: not held), the locator's first column
        # as an array, for the vectorised win attribution; None once the
        # gids are too sparse for an array (the locator answers then)
        self._gid_seg: Optional[np.ndarray] = np.full((0,), -1, np.int32)
        self._next_gid = 0
        self._lock = threading.RLock()
        self.n_rejected = 0
        # the maintenance handle, built lazily; _compact_deletes is the
        # delete ledger a compaction opens at freeze and re-applies at swap
        self._maintenance = None
        self._compact_deletes: Optional[set] = None
        # durability: with a WAL attached every mutation is appended before
        # it is applied; _wal_mute silences mutations that follow from a
        # logged record (replay itself)
        self._wal: Optional[walmod.WriteAheadLog] = None
        self._wal_mute = False
        # placement across a serve mesh (shard): two mutation counters
        # drive the lazy rebuild -- _version bumps at every mutation (the
        # delta is re-taken), _sealed_version only when the sealed set or
        # a sealed live mask changes (the placement is diffed)
        self._mesh = None
        self._shard_axis: Optional[str] = None
        self._placement = None
        self._version = 0
        self._sealed_version = 0
        # the replication policy (None, an int, or factors per sealed
        # segment), normalized against the mesh at each placement build
        self._replication = None
        self._router: Optional[QueryRouter] = None
        # the route plan of this thread's last sharded query, for
        # fanout_telemetry (the batcher calls it on the same thread)
        self._tls = threading.local()
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

    @property
    def maintenance(self):
        """The maintenance handle (``serve.maintenance.IndexMaintenance``):
        owns ``seal()`` and ``compact()`` and runs one at a time.  Insert,
        delete and query stay on the index."""
        if self._maintenance is None:
            from .maintenance import IndexMaintenance
            self._maintenance = IndexMaintenance(self)
        return self._maintenance

    def seal(self) -> None:
        """Deprecated: use ``index.maintenance.seal()``."""
        warnings.warn(
            "SegmentedIndex.seal() is deprecated; seal through the "
            "maintenance plane (index.maintenance.seal())",
            DeprecationWarning, stacklevel=2)
        self._maint_seal()

    def _maint_seal(self) -> None:
        """Seal the current delta (no-op if empty) and open a fresh one.

        Logged as an explicit SEAL record; the seal ``insert`` makes when
        the delta fills is not logged (replaying the INSERT reproduces
        it)."""
        with self._lock:
            if self.delta.n_items == 0:
                return
            with obs_trace.tracer().span("seal", tenant=self.tenant,
                                         rows=self.delta.n_items):
                self._log(walmod.encode_seal())
                # crash point: the SEAL record is framed, nothing applied
                # yet
                faults.fire("seal")
                self._seal()

    def _seal(self) -> None:
        """Apply a seal (callers hold the lock): stack the delta and open a
        fresh one.

        Under a quantized tier this is the encode point, and the encode and
        the copy into the stack run before the sealed flag flips, so a
        failed encode leaves the delta mutable and untouched.  fp32 tenants
        never encode."""
        seg = self.delta
        if seg.n_items == 0:
            return
        if self.precision == "fp32":
            self._stack.seal(seg, seg.state.db)
        else:
            self._stack.seal(seg, *self._encode(seg))
        seg.sealed = True
        self._open_segment()
        self._version += 1
        self._sealed_version += 1
        self._publish_store_metrics()

    def _publish_store_metrics(self) -> None:
        """The ``store_bytes_per_item`` gauge, from host counters."""
        per_item = self.store_bytes_per_item()
        if per_item is not None:
            obs_metrics.registry().set("store_bytes_per_item", per_item,
                                       tenant=self.tenant)

    def _place(self, gids: np.ndarray, si: int) -> None:
        """Record segment ``si`` as the holder of ``gids`` in the gid ->
        segment array (callers hold the lock and update the locator).  Gids
        far above the item count (a caller's own, sparse) drop the array:
        it would take their range in memory."""
        if not gids.size or self._gid_seg is None:
            return
        top = int(gids.max()) + 1
        if top > self._gid_seg.size:
            if top > max(1 << 20, 8 * len(self._locator)):
                self._gid_seg = None
                return
            grown = np.full((max(top, 2 * self._gid_seg.size),), -1,
                            np.int32)
            grown[:self._gid_seg.size] = self._gid_seg
            self._gid_seg = grown
        self._gid_seg[gids] = si

    def _encode(self, seg: Segment):
        """One about-to-seal segment in the storage tier: (codes, scale,
        its fp32 rows on the host as the survivor pool)."""
        pool = seg.state.db.cpu().numpy()
        if not np.isfinite(pool).all():
            # insert() already refuses NaN/Inf; a non-finite row would
            # corrupt the segment's shared scale
            raise ValueError(
                f"segment holds non-finite embeddings; refusing to "
                f"quantize to {self.precision} at seal")
        codes, scale = quantize.encode(seg.state.db, self.precision)
        return codes, scale, pool

    # -- durability ---------------------------------------------------------

    def attach_wal(self, wal: Optional[walmod.WriteAheadLog]) -> None:
        """Log every later mutation to ``wal`` (None detaches)."""
        with self._lock:
            self._wal = wal

    @property
    def wal(self) -> Optional[walmod.WriteAheadLog]:
        return self._wal

    def _logging(self) -> bool:
        return self._wal is not None and not self._wal_mute

    def _log(self, payload: bytes) -> None:
        """Append one record (write-ahead: callers log, then apply, under
        the lock, so the log's order is the apply order)."""
        if self._logging():
            self._wal.append(payload)

    def replay(self, wal_path: str, start: int = 0) -> dict:
        """Apply the WAL records in ``wal_path`` from byte ``start``.

        Duplicate-gid inserts (records this index already holds: a replay
        over a restored snapshot, or after a partial apply) are dropped
        and counted; deletes, seals and compactions are idempotent.  The
        scan stops at the first bad frame.  Returns ``read_wal``'s report
        plus ``applied`` (records applied) and ``dropped_duplicates``.
        Appends nothing to the attached WAL."""
        records, report = walmod.read_wal(wal_path, start=start)
        return dict(report, **self.apply_records(records))

    def apply_records(self, records) -> dict:
        """Apply decoded WAL records (the replay core, which the warm
        standby feeds as it tails a live log).  Returns ``{"applied",
        "dropped_duplicates"}``."""
        out = {"applied": 0, "dropped_duplicates": 0}
        with self._lock:
            self._wal_mute = True
            try:
                for rec in records:
                    if rec.op == walmod.OP_INSERT:
                        gids = np.asarray(rec.gids, np.int32)
                        fresh = np.fromiter(
                            (g not in self._locator for g in gids.tolist()),
                            bool, gids.size)
                        out["dropped_duplicates"] += int((~fresh).sum())
                        if fresh.any():
                            self.insert(rec.embeddings[fresh],
                                        gids=gids[fresh])
                    elif rec.op == walmod.OP_DELETE:
                        self.delete(rec.gids)
                    elif rec.op == walmod.OP_SEAL:
                        self._seal()
                    elif rec.op == walmod.OP_COMPACT:
                        self._maint_compact()
                    elif rec.op == walmod.OP_SET_REPLICATION:
                        self._maint_set_replication(rec.value)
                    # REGISTER and LIFECYCLE are the registry's: no-ops
                    out["applied"] += 1
            finally:
                self._wal_mute = False
        return out

    def _maint_set_replication(self, replication) -> None:
        """Log and set the sealed-segment replication policy: None (factor
        1), an int (every sealed segment, the ``static:k`` policy) or
        factors per sealed segment (what ``auto`` derives from
        ``shard_balance``), clipped to the mesh at each placement build.
        Replicas are bit-equal, so it changes where queries run, never what
        they answer; it takes effect at the next sharded query (a rebuild
        and a fresh router) and is kept across shard()/unshard()."""
        with self._lock:
            if replication is not None and not isinstance(replication, int):
                replication = tuple(int(f) for f in replication)
            self._log(walmod.encode_set_replication(replication))
            self._replication = replication
            self._version += 1
            self._sealed_version += 1

    def set_replication(self, replication) -> None:
        """Deprecated: use ``index.maintenance.set_replication(...)``."""
        warnings.warn(
            "SegmentedIndex.set_replication() is deprecated; set policy "
            "through the maintenance plane "
            "(index.maintenance.set_replication(...))",
            DeprecationWarning, stacklevel=2)
        self._maint_set_replication(replication)

    def replication(self):
        """The replication policy as set (not normalized)."""
        return self._replication

    # -- placement across a serve mesh --------------------------------------

    def shard(self, mesh, axis: str = "serve") -> None:
        """Serve queries over ``mesh`` (a ``launch.mesh.ServeMesh``): the
        live sealed segments round robin over its ``axis``, the delta
        scored on rank 0.  Answers stay bit-equal to the stacked query;
        the placement is built at the next query (or
        :meth:`refresh_placement`)."""
        if axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}, no {axis!r} axis")
        with self._lock:
            self._mesh = mesh
            self._shard_axis = axis
            self._placement = None
            self._router = None

    def unshard(self) -> None:
        """Back to the stacked query on the index's device (drops the
        placement and its rank blocks)."""
        with self._lock:
            self._mesh = None
            self._shard_axis = None
            self._placement = None
            self._router = None

    def _current_placement(self):
        """The up-to-date placement (callers hold the lock).  A changed
        sealed set rebuilds through the last placement (a diff: unchanged
        slots move 0 bytes) and publishes the bytes moved
        (``placement_replaced_bytes_total``), a full restack's
        (``placement_restack_bytes_total``) and the rebuild
        (``placement_rebuilds_total{kind}``), and gets a fresh router when
        a factor exceeds 1; a delta-only change re-takes the delta."""
        pl = self._placement
        if pl is None or pl.version != self._sealed_version:
            sealed = [s for s in self.segments[:-1] if s.n_live > 0]
            pl = seg_placement.place_segments(
                sealed, self.delta, self._mesh, self._shard_axis,
                self._sealed_version, replication=self._replication,
                prev=pl, db_dtype=quantize.storage_dtype(self.precision),
                quantized=self.precision != "fp32",
                delta_version=self._version)
            self._placement = pl
            reg = obs_metrics.registry()
            reg.inc("placement_replaced_bytes_total", pl.replaced_bytes,
                    tenant=self.tenant)
            reg.inc("placement_restack_bytes_total", pl.sealed_bytes,
                    tenant=self.tenant)
            reg.inc("placement_rebuilds_total", tenant=self.tenant,
                    kind="diff" if pl.diffed else "full")
            # a fresh ledger per placement: the instances it balances
            # over just changed
            self._router = (QueryRouter(pl.layout(), tenant=self.tenant)
                            if any(f > 1 for f in pl.replication) else None)
        elif pl.delta_version != self._version:
            pl = seg_placement.refresh_delta(pl, self.delta, self._version)
            self._placement = pl
        return pl

    def refresh_placement(self) -> None:
        """Pay the lazy placement rebuild now, off the query path (the
        maintenance handle calls it after each operation).  No-op when
        unsharded."""
        with self._lock:
            if self._mesh is not None:
                self._current_placement()

    def shard_layout(self) -> Optional[dict]:
        """The placement as data (``placement.layout_dict``), from host
        counters only -- it never builds a placement; None when
        unsharded."""
        with self._lock:
            if self._mesh is None:
                return None
            n_sealed = sum(1 for s in self.segments[:-1] if s.n_live > 0)
            return seg_placement.layout_dict(self._mesh, self._shard_axis,
                                             n_sealed,
                                             replication=self._replication)

    def load_segments(self, segments: Sequence[Segment],
                      next_gid: int) -> None:
        """Replace the index's contents by ``segments`` (a snapshot's, in
        order, every one sealed but the last), rebuilding the stack and
        the locator.  The family becomes segment 0's, and every segment
        must hold the same one."""
        family = tuple(t.to(self.device) for t in (
            segments[0].state.alpha, segments[0].state.b,
            segments[0].state.mix))
        with self._lock:
            for seg in segments:
                st = seg.state
                if not all(torch.equal(a, b) for a, b in zip(
                        (st.alpha, st.b, st.mix), family)):
                    raise ValueError("segments hold different hash "
                                     "families")
                seg.state = dataclasses.replace(
                    st, alpha=family[0], b=family[1], mix=family[2])
            self.family = family
            self._stack = SegmentStack(
                self.cfg, self.segment_capacity,
                quantize.storage_dtype(self.precision),
                self.precision != "fp32", self.device)
            self.segments = []
            self._locator = {}
            self._gid_seg = np.full((0,), -1, np.int32)
            for seg in segments:
                if seg.sealed:
                    self._stack.seal(seg, seg.state.db, seg.scale, seg.pool)
                si = len(self.segments)
                self.segments.append(seg)
                held = seg.gids[:seg.n_items].cpu().numpy()
                for slot, g in enumerate(held.tolist()):
                    self._locator[g] = (si, slot)
                self._place(held, si)
            if not self.segments or self.delta.sealed:
                self._open_segment()
            self._next_gid = int(next_gid)
            # a sharded tenant re-places onto its mesh, of any size
            self._version += 1
            self._sealed_version += 1

    def layout(self) -> dict:
        """The stack's report: sealed count, slots, bytes."""
        return self._stack.layout()

    def store_bytes_per_item(self) -> Optional[float]:
        """Sealed-store bytes per live sealed item (the tier's capacity
        win; the JAX package's store_bytes_per_item gauge).  None before
        the first seal."""
        sealed = [s for s in self.segments[:-1] if s.n_items > 0]
        items = sum(s.n_live for s in sealed)
        if not items:
            return None
        return sum(s.state.db.nbytes for s in sealed) / items

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
                # write-ahead: the record (resolved gids, the f32 rows as
                # stored) is in the log before the first row lands
                if self._logging():
                    self._log(walmod.encode_insert(out_gids,
                                                   emb.cpu().numpy()))
            gids_dev = torch.as_tensor(out_gids, device=self.device)
            pos = 0
            while pos < m:
                seg = self.delta
                room = seg.capacity - seg.n_items
                if room == 0:
                    self._seal()         # not logged: the INSERT replays it
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
                self._place(out_gids[pos:pos + take], si)
                seg.n_items += take
                seg.n_live += take
                pos += take
            self._version += 1
        return out_gids

    def delete(self, gids: Sequence[int]) -> int:
        """Tombstone items by global id; returns how many were live."""
        with self._lock:
            req = np.asarray(gids).ravel().astype(np.int32)
            if req.size:
                # logged as requested: a delete of dead or unknown gids
                # replays as a no-op
                self._log(walmod.encode_delete(req))
            if self._compact_deletes is not None:
                # a compaction froze its input before this delete: ledger
                # every requested gid, so the swap re-applies it to the
                # shadow's copy (re-applying is idempotent)
                self._compact_deletes.update(req.tolist())
            return self._tombstone(req.tolist())

    def _tombstone(self, req: List[int]) -> int:
        """Apply a delete (callers hold the lock; never logs)."""
        by_seg: dict = {}
        for g in req:
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
            seg._live_key = None
            n += hits
            self._version += 1
            if seg.sealed:
                self._sealed_version += 1
        return n

    def live_items(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every live item on the device: (embeddings (n_live, N) f32,
        gids (n_live,)).  Quantized segments give their exact fp32 rows from
        the survivor pool, never decoded codes."""
        with self._lock:
            emb_parts, gid_parts = [], []
            for seg in self.segments:
                if seg.n_live == 0:
                    continue
                live = seg.live[:seg.n_items]
                db = (seg.state.db if seg.pool is None else torch.as_tensor(
                    seg.pool, device=self.device))
                emb_parts.append(db[:seg.n_items][live])
                gid_parts.append(seg.gids[:seg.n_items][live])
        if not emb_parts:
            return (torch.zeros((0, self.cfg.n_dims), device=self.device),
                    torch.zeros((0,), dtype=torch.int32, device=self.device))
        return torch.cat(emb_parts), torch.cat(gid_parts)

    def compact(self) -> int:
        """Deprecated: use ``index.maintenance.compact()``."""
        warnings.warn(
            "SegmentedIndex.compact() is deprecated; compact through the "
            "maintenance plane (index.maintenance.compact())",
            DeprecationWarning, stacklevel=2)
        return self._maint_compact()

    def _maint_compact(self) -> int:
        """Re-pack the live items into fresh segments (tombstoned rows are
        dropped, gids are kept).  Returns the number of segments after it.

        Three phases, so a worker thread can run the costly one while
        queries and writes go on:

        1. **freeze** (locked): seal the delta, so the input -- every
           segment but the new delta -- is sealed, and open the delete
           ledger;
        2. **build** (no lock): insert the frozen segments' live rows, in
           gid order, into a *shadow* index with this one's family, config
           and tier;
        3. **swap** (locked): adopt the shadow's segments, stack and
           locator (or splice in the segments made since the freeze), and
           re-apply the ledgered deletes.

        Called inline, the three run back to back.  Queries answer from
        the old segments until the swap and from the new ones after it;
        with no bucket overflowing both answers are equal (invariant 11,
        "maintenance is invisible").  Where buckets overflow, which items
        a table holds depends on the insert order, so the answers may
        differ, each the answer of one whole state.
        """
        frozen_n, frozen = self._compact_freeze()
        try:
            shadow = self._compact_build(frozen)
        except BaseException:
            with self._lock:
                self._compact_deletes = None      # close the ledger
            raise
        return self._compact_swap(frozen_n, shadow)

    def _compact_freeze(self) -> Tuple[int, List[Segment]]:
        """Phase 1 (locked): log COMPACT and make the compaction's input
        immutable."""
        with self._lock:
            self._log(walmod.encode_compact())
            # crash point: COMPACT is framed, nothing applied yet
            faults.fire("compact.freeze")
            self._seal()                 # no-op when the delta is empty
            frozen = list(self.segments[:-1])
            self._compact_deletes = set()
            return len(frozen), frozen

    def _compact_build(self, frozen: List[Segment]) -> "SegmentedIndex":
        """Phase 2 (no lock): the shadow index of the frozen segments' live
        items, their fp32 rows (on a quantized tier the survivor pool's,
        never decoded codes) inserted in gid order.

        Frozen segments are sealed, so concurrent writes can only flip
        their live masks, and every such delete is in the ledger.  A seal
        that doubles the stack meanwhile rebinds their views to a copy
        with the same bytes; each attribute read here is one or the
        other."""
        shadow = SegmentedIndex(
            self.cfg, segment_capacity=self.segment_capacity,
            insert_chunk=self.insert_chunk, family=self.family,
            precision=self.precision, survivor_k=self.survivor_k,
            device=self.device)
        if not frozen:
            return shadow
        live = torch.stack([s.live for s in frozen])
        gids = torch.stack([s.gids for s in frozen])[live]
        if self.precision == "fp32":
            emb = torch.stack([s.state.db for s in frozen])[live]
        else:
            emb = torch.as_tensor(
                np.stack([s.pool for s in frozen])[live.cpu().numpy()],
                device=self.device)
        order = torch.argsort(gids, stable=True)
        if order.numel():
            shadow.insert(emb[order], gids=gids[order].cpu().numpy())
        return shadow

    def _compact_swap(self, frozen_n: int, shadow: "SegmentedIndex") -> int:
        """Phase 3 (locked): publish the shadow.

        The index always keeps the shadow's ``SegmentStack`` (the old one
        is dropped with the last view of it): its sealed segments are views
        of that stack.  With nothing written since the freeze the index
        adopts the shadow whole, its delta included.  Otherwise the
        shadow's delta is sealed, the segments made since the freeze (the
        current delta last) are spliced behind the shadow's, and the
        shadow's stack is rebuilt over the new sealed set
        (``SegmentStack.rebuild``: slot i = sealed segment i, views
        rebound)."""
        with self._lock, obs_trace.tracer().span(
                "compact", tenant=self.tenant, n_live=self.n_live,
                segments_before=len(self.segments)):
            # crash point: the shadow is built, the swap not yet applied
            faults.fire("compact.swap")
            after = self.segments[frozen_n:]
            self._gid_seg = shadow._gid_seg
            if len(after) == 1 and after[0].n_items == 0:
                self.segments = shadow.segments
                self._locator = shadow._locator
                self._stack = shadow._stack
            else:
                shadow._seal()
                sealed = shadow.segments[:-1] + after[:-1]
                shadow._stack.rebuild(sealed)
                self.segments = sealed + after[-1:]
                self._stack = shadow._stack
                locator = shadow._locator
                base = len(shadow.segments) - 1
                for j, seg in enumerate(after):
                    held = seg.gids[:seg.n_items].cpu().numpy()
                    for slot, g in enumerate(held.tolist()):
                        locator[g] = (base + j, slot)
                    self._place(held, base + j)
                self._locator = locator
            pending, self._compact_deletes = self._compact_deletes, None
            if pending:
                self._tombstone(sorted(pending))
            self._version += 1
            self._sealed_version += 1
            self._publish_store_metrics()
            return len(self.segments)

    # -- query --------------------------------------------------------------

    def query(self, queries, k: int, n_probes: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-segment k-NN: (nq, N) -> (gids (nq, k), dists (nq, k)).

        One stacked query over every segment
        (``core.distributed.query_segments_stacked``); on a quantized tier
        its stage 1 (see :meth:`_query_quantized`).  A row holding a NaN
        or an infinity answers (-1, +inf) in every slot.

        Inside a sampled trace with deep tracing on, an fp32 query runs
        the staged form (:class:`_StageSpans`); the int8 and bf16 tiers
        never do, as in the JAX package."""
        q, finite = self._queries(queries)
        if not any(s.n_live for s in self.segments):
            return self._no_results(q.shape[0], k)
        if self.precision != "fp32":
            return _blank_rows(*self._query_quantized(q, k, n_probes),
                               finite)
        tr = obs_trace.tracer()
        stage = (_StageSpans(tr, self.tenant, self.device)
                 if tr.deep and tr.sampled() else None)
        with self._lock:
            return _blank_rows(*self._query_placed(q, k, n_probes, stage),
                               finite)

    def _queries(self, queries
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The batch as contiguous f32 on the device with its NaN and
        +-inf entries zeroed, and the mask of its all-finite rows (None when
        every row is): no kernel sees a NaN (K3's select route orders
        none), and :func:`_blank_rows` answers every other row (-1, +inf)
        afterwards.  A batch on the host (numpy, as the batcher sends) is
        checked there, and an all-finite one goes to the device as it is:
        no kernel.  Otherwise four kernels: ``q - q == 0`` holds exactly at
        the finite entries (inf - inf and NaN - NaN are NaN), one select
        zeroes the rest, one reduction gives the rows."""
        if isinstance(queries, np.ndarray):
            host = np.asarray(queries, np.float32)
            if np.isfinite(host).all():
                return torch.as_tensor(host, device=self.device
                                       ).contiguous(), None
            queries = host
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        ok = (q - q) == 0
        return torch.where(ok, q, 0.0), ok.all(dim=1)

    def _query_placed(self, q: torch.Tensor, k: int, n_probes: int,
                      stage=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stacked query, or when sharded the sharded one over the
        current placement, the router's plan for this batch kept for
        :meth:`fanout_telemetry` (callers hold the lock)."""
        if self._mesh is None:
            self._tls.plan = None
            return self._query_stacked(q, k, n_probes, stage)
        pl = self._current_placement()
        plan = self._router.route() if self._router is not None else None
        self._tls.plan = plan
        st = self.delta.state
        g, d = distributed.query_segments_sharded(
            pl, (st.alpha, st.b, st.mix), self.cfg, q, k, n_probes=n_probes,
            active=None if plan is None else plan.active, stage=stage)
        return g.to(self.device), d.to(self.device)

    def _query_stacked(self, q: torch.Tensor, k: int, n_probes: int,
                       stage=None) -> Tuple[torch.Tensor, torch.Tensor]:
        st = self.delta.state
        return distributed.query_segments_stacked(
            self._stack, self.delta, (st.alpha, st.b, st.mix), self.cfg, q,
            k, n_probes=n_probes, stage=stage)

    def _query_fanout(self, queries, k: int, n_probes: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`query` by the per-segment fan-out, the JAX package's
        unsharded path: one ``query_index_gids`` per non-empty segment
        (each re-hashing the batch; K5 on a quantized sealed segment),
        merged by ``ops.merge_topk`` (a single segment is merged too, so
        tie order does not depend on the segment count).  The stacked
        query's reference: it returns the same bits.  Only the tests and
        the chip smoke's parity phase call it."""
        q, finite = self._queries(queries)
        kq = self._survivor_width(k, n_probes)
        with self._lock:
            shards = []
            for seg in self.segments:
                if seg.n_live == 0:
                    continue
                if seg.scale is not None:
                    shards.append(lidx.query_index_gids_quantized(
                        seg.state, self.cfg, q, kq, seg.gids, seg.scale,
                        n_probes=n_probes, live_mask=seg.live))
                else:
                    shards.append(lidx.query_index_gids(
                        seg.state, self.cfg, q, kq, seg.gids,
                        n_probes=n_probes, live_mask=seg.live))
        if not shards:
            return self._no_results(q.shape[0], k)
        g, d = _merged(torch.cat([d for _, d in shards], dim=1),
                       torch.cat([g for g, _ in shards], dim=1), kq)
        if self.precision == "fp32":
            return _blank_rows(g, d, finite)
        return _blank_rows(*self._rescore(q, g, k), finite)

    def _no_results(self, nq: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(-1, +inf) for every slot: the answer of an empty index."""
        return (torch.full((nq, k), -1, dtype=torch.int32,
                           device=self.device),
                torch.full((nq, k), torch.inf, device=self.device))

    def _survivor_width(self, k: int, n_probes: int) -> int:
        """The quantized query's survivor width m (k on an fp32 tenant)."""
        if self.precision == "fp32":
            return k
        return quantize.survivor_width(
            k, self.survivor_k,
            self.cfg.n_tables * n_probes * self.cfg.bucket_capacity)

    def _query_quantized(self, q: torch.Tensor, k: int, n_probes: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-stage quantized query: code-space candidate scoring to a
        survivor pool of ``m >= k``, then an exact fp32 rescore of the
        merged survivors.

        Stage 1 is the stacked query at width ``m = survivor_width(k,
        survivor_k, L * n_probes * S)``: one K5 launch over every sealed
        segment's codes, K2 (exact) against the fp32 delta, merged by K3.
        Stage 2 (:meth:`_rescore`) gathers the survivors' fp32 rows from
        the host pool and reranks them under the same (distance, gid)
        order, so any survivor set holding the true top-k yields the fp32
        answer."""
        kq = self._survivor_width(k, n_probes)
        with self._lock:
            g, _ = self._query_placed(q, kq, n_probes)
        return self._rescore(q, g, k)

    def _rescore(self, q: torch.Tensor, g: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 2 of the quantized query: the (nq, m) survivor gids ``g``
        rescored exactly from their fp32 rows (K6 + K3)."""
        g_np = g.cpu().numpy().copy()
        rows = self._survivor_rows(g_np)
        g, d = quantize.rerank_survivors(
            q, torch.as_tensor(rows, device=self.device),
            torch.as_tensor(g_np, device=self.device), k, p=self.cfg.p)
        if g_np.size:
            self.rerank_survivor_frac = float((g_np >= 0).mean())
            obs_metrics.registry().set("rerank_survivor_frac",
                                       self.rerank_survivor_frac,
                                       tenant=self.tenant)
        return g, d

    def _survivor_rows(self, g_np: np.ndarray) -> np.ndarray:
        """Exact fp32 rows for a (nq, m) survivor-gid matrix.

        Rows of sealed quantized segments come from the stack's host pool
        in one gather; a segment without a pool (the delta) copies its
        device ``db`` to the host once per batch.  Gids the locator does
        not know are set to -1 in place, so the rerank drops them instead
        of scoring a zero row."""
        nq, m = g_np.shape
        flat = g_np.reshape(-1).copy()
        rows = np.zeros((nq * m, self.cfg.n_dims), np.float32)
        with self._lock:
            at = np.flatnonzero(flat >= 0)
            uniq, inv = np.unique(flat[at], return_inverse=True)
            loc = np.fromiter(itertools.chain.from_iterable(map(
                self._locator.get, uniq.tolist(),
                itertools.repeat((-1, -1)))), np.int64, 2 * uniq.size)
            loc = loc.reshape(-1, 2)[inv.reshape(-1)]
            known = loc[:, 0] >= 0
            flat[at[~known]] = -1
            at, si, slot = at[known], loc[known, 0], loc[known, 1]
            pooled = np.zeros(si.shape, bool)
            if self._stack.pool is not None:
                pooled = si < self._stack.n_sealed
                rows[at[pooled]] = self._stack.pool[si[pooled], slot[pooled]]
            for s in np.unique(si[~pooled]).tolist():
                own = ~pooled & (si == s)
                rows[at[own]] = self.segments[s].state.db.cpu().numpy()[
                    slot[own]]
        g_np[...] = flat.reshape(nq, m)
        return rows.reshape(nq, m, self.cfg.n_dims)

    def segment_wins(self, g_np: np.ndarray) -> np.ndarray:
        """Top-k slots of a merged answer (host gids, -1 for an empty
        slot) won per segment, by position in :attr:`segments`."""
        flat = np.asarray(g_np).ravel()
        flat = flat[flat >= 0]
        with self._lock:
            if self._gid_seg is None:
                seg = np.fromiter((self._locator.get(g, (-1,))[0]
                                   for g in flat.tolist()), np.int64,
                                  flat.size)
            else:
                seg = self._gid_seg[flat[flat < self._gid_seg.size]]
            return np.bincount(seg[seg >= 0],
                               minlength=len(self.segments))

    def fanout_telemetry(self, g_np: np.ndarray) -> None:
        """Feed the ``on_fanout`` hook one merged answer's wins per segment
        (the servable's batcher calls it with each chunk's host ids, which
        it copies anyway; None hook: nothing).  When sharded, also the wins
        per rank -- through the plan of this thread's last query when the
        router picked replicas (the win goes to the replica that answered,
        and the plan's instances per rank go along as the load), else
        through the placement's assignment (a replica's wins to its first
        holder); the delta's go to rank 0."""
        if self._on_fanout is None:
            return
        plan = getattr(self._tls, "plan", None)
        self._tls.plan = None
        wins = self.segment_wins(g_np)
        with self._lock:
            pl = self._placement if self._mesh is not None else None
            dev_wins = None if pl is None else self._device_wins(wins, pl,
                                                                 plan)
        if dev_wins is None:
            self._on_fanout(wins)
        elif plan is not None:
            self._on_fanout(wins, dev_wins, None, plan.per_device_active)
        else:
            self._on_fanout(wins, dev_wins)

    def _device_wins(self, wins: np.ndarray, pl, plan) -> np.ndarray:
        """Wins per rank from wins per segment (callers hold the lock):
        each live sealed segment's go to the rank ``plan`` routed it to,
        or with no plan to its first holder in ``pl``; the delta's, and
        any segment the placement does not know yet, to rank 0."""
        sealed_pos = [i for i, s in enumerate(self.segments[:-1])
                      if s.n_live > 0]
        dev_of = np.zeros(wins.size, np.int64)
        if plan is not None:
            for fi, dev in plan.dev_of.items():
                if fi < len(sealed_pos):
                    dev_of[sealed_pos[fi]] = dev
        else:
            # lowest rank last, so a replicated segment ends at its first
            # holder; the placement may lag a concurrent mutation
            for dev in range(pl.n_dev - 1, -1, -1):
                for fi in pl.assignment[dev]:
                    if fi < len(sealed_pos):
                        dev_of[sealed_pos[fi]] = dev
        return np.bincount(dev_of, weights=wins,
                           minlength=pl.n_dev).astype(np.int64)

    def occupancy(self) -> List[dict]:
        return [s.occupancy() for s in self.segments]


class _StageSpans:
    """The staged engine's ``stage``: ``stage(name)`` is a span of the
    tracer around one stage of the stacked query that, on the card, ends
    with a device sync inside it, so the span holds the stage's device time
    and not only its dispatch.  The stages run one after another, never
    nested, so one object serves them all."""

    __slots__ = ("tracer", "tenant", "sync", "span")

    def __init__(self, tracer, tenant: str, device: torch.device):
        self.tracer = tracer
        self.tenant = tenant
        self.sync = device if device.type == "cuda" else None
        self.span = None

    def __call__(self, name: str) -> "_StageSpans":
        self.span = self.tracer.span(name, tenant=self.tenant)
        return self

    def __enter__(self) -> "_StageSpans":
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self.sync is not None:
            torch.cuda.synchronize(self.sync)
        return self.span.__exit__(*exc)


def _blank_rows(g: torch.Tensor, d: torch.Tensor,
                finite: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gids, dists) with every row that ``finite`` does not mark set to
    (-1, +inf) (None: every row is finite)."""
    if finite is None:
        return g, d
    rows = finite[:, None]
    return torch.where(rows, g, -1), torch.where(rows, d, torch.inf)


def _merged(dists: torch.Tensor, gids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    d, g = ops.merge_topk(dists, gids, k)
    return g, d
