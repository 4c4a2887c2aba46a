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

The multi-device half (:func:`place_segments`, a :class:`SegmentPlacement`)
serves a sharded index over a ``launch.mesh.ServeMesh``:

* the live sealed segments go **round robin** over the mesh's ranks
  (segment ``i`` to rank ``i % n_dev``), and with per-segment
  **replication** factors (:func:`normalize_replication`) each extra
  replica lands on the least-loaded rank that lacks one
  (:func:`replicated_assignment`); factor 1 everywhere is round robin;
* each rank holds its ``per_dev`` instances in a :class:`RankBlock` on its
  own device: one tensor per leaf (table, db, gids, live, and on a
  quantized tier one scale an instance), instance ``j`` in row ``j``;
  ranks with fewer instances hold **padding** rows, every slot dead
  (gids -1, live False), that answer only (-1, +inf); a rank needs no
  survivor pool (the rescore reads the index's host pool by gid);
* the delta is not copied per rank: rank 0 scores it (on rank 0's device,
  so it is copied there when the index lives elsewhere, and re-copied by
  :func:`refresh_delta` after a delta-only mutation);
* a rebuild handed the previous placement (``prev=``) **diffs** it: each
  slot has a ``(content, live)`` fingerprint (``Segment.placement_key``);
  an unchanged slot moves 0 bytes, a live-only change rewrites the mask
  row, a new or changed slot its whole row, and a freed slot gets a dead
  gids and live row.  ``replaced_bytes`` is what a build moved and
  ``sealed_bytes`` what a full restack would have;
* the stripe width ``per_dev`` grows by capacity doubling and shrinks
  only at a quarter (:func:`headroom`, the JAX ``_headroom_per_dev``), so
  seals fill headroom slots by diff.

The bytes count the leaves a rank holds: table, db, gids and live (and the
4-byte scale on a quantized tier); the JAX package counts its replicated
family leaves too, which the port keeps once, on the index.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

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



# -- the multi-device half ----------------------------------------------------


def round_robin(n_items: int, n_dev: int) -> List[List[int]]:
    """``assignment[d]``: the item indices rank ``d`` owns (``i % n_dev``)."""
    return [[i for i in range(n_items) if i % n_dev == d]
            for d in range(n_dev)]


def normalize_replication(n_sealed: int, n_dev: int,
                          replication) -> Tuple[int, ...]:
    """Per-segment factors as a tuple of length ``n_sealed``, each clipped
    to [1, n_dev], missing positions 1.  ``replication``: None (all 1), an
    int (every sealed segment) or a positional sequence."""
    if replication is None:
        return (1,) * n_sealed
    if isinstance(replication, int):
        return (max(1, min(int(replication), n_dev)),) * n_sealed
    fac = [max(1, min(int(f), n_dev)) for f in replication][:n_sealed]
    fac += [1] * (n_sealed - len(fac))
    return tuple(fac)


def replicated_assignment(n_sealed: int, n_dev: int,
                          factors: Sequence[int]) -> List[List[int]]:
    """Instance-level assignment under per-segment replication: primaries
    round robin (so all-1 factors give :func:`round_robin` exactly), then
    each extra replica on the least-loaded rank without a copy of that
    segment (ties to the lowest rank).  Deterministic."""
    assignment = round_robin(n_sealed, n_dev)
    holders = [{i % n_dev} for i in range(n_sealed)]
    for i in range(n_sealed):
        for _ in range(factors[i] - 1):
            free = [d for d in range(n_dev) if d not in holders[i]]
            if not free:
                break
            d = min(free, key=lambda d: (len(assignment[d]), d))
            assignment[d].append(i)
            holders[i].add(d)
    return assignment


def layout_dict(mesh, axis: str, n_sealed: int, replication=None) -> dict:
    """Where ``n_sealed`` sealed segments land on ``mesh``'s ``axis``: the
    one source of the counts and the assignment, which
    :func:`place_segments` builds from and ``SegmentedIndex.shard_layout``
    reports, so the report cannot drift from what runs."""
    n_dev = int(mesh.shape[axis])
    factors = normalize_replication(n_sealed, n_dev, replication)
    assignment = replicated_assignment(n_sealed, n_dev, factors)
    return {
        "axis": axis,
        "mesh_axes": list(mesh.axis_names),
        "mesh_shape": [int(mesh.shape[a]) for a in mesh.axis_names],
        "n_dev": n_dev,
        "per_dev": max(1, max(len(a) for a in assignment)),
        "n_sealed": n_sealed,
        "n_instances": int(sum(factors)),
        "replication": list(factors),
        "assignment": assignment,
    }


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """One rank's ``per_dev`` instances on ``device``: ``table`` (per_dev,
    L, B, slots) int32, ``db`` (per_dev, cap, N) at the tier's dtype,
    ``gids`` (per_dev, cap) int32, ``live`` (per_dev, cap) bool and, on a
    quantized tier, ``scale`` (per_dev,) f32 (1.0 on padding rows)."""

    device: torch.device
    table: torch.Tensor
    db: torch.Tensor
    gids: torch.Tensor
    live: torch.Tensor
    scale: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        n = sum(t.nbytes for t in (self.table, self.db, self.gids,
                                   self.live))
        return n + (self.scale.nbytes if self.scale is not None else 0)


@dataclasses.dataclass(frozen=True)
class SegmentPlacement:
    """A sharded index's placement at one sealed-set ``version``.

    ``blocks[d]``: rank d's :class:`RankBlock`; ``assignment[d]``: the
    positions (in the placed sealed list) of rank d's instances, in row
    order, a replicated segment in several ranks' lists; ``replication``:
    the normalized factors; ``delta``: the delta segment on rank 0's
    device (the index's own ``Segment`` when that is its device);
    ``slot_keys``: the ``(content, live)`` fingerprint of each slot in
    rank-stripe order (None: padding); ``replaced_bytes`` /
    ``sealed_bytes``: what this build moved / a full restack would move."""

    mesh: Any
    axis: str
    n_dev: int
    per_dev: int
    n_sealed: int
    version: int
    blocks: Tuple[RankBlock, ...]
    assignment: tuple
    replication: tuple = ()
    delta: Any = None
    delta_version: int = -1
    slot_keys: tuple = ()
    replaced_bytes: int = 0
    sealed_bytes: int = 0
    diffed: bool = False

    @property
    def quantized(self) -> bool:
        return self.blocks[0].scale is not None

    def layout(self) -> dict:
        """:func:`layout_dict` with the stripe width that serves (headroom
        included): the router's slot math and the active mask use it."""
        lay = layout_dict(self.mesh, self.axis, self.n_sealed,
                          replication=self.replication or None)
        lay["per_dev"] = self.per_dev
        return lay

    def nbytes(self) -> List[int]:
        """Device bytes of each rank's block."""
        return [b.nbytes() for b in self.blocks]


def _slot_key_table(segments: Sequence, assignment, per_dev: int,
                    version: int) -> tuple:
    """Each slot's wanted fingerprint: ``seg.placement_key()`` for a real
    slot, None for padding.  A segment without fingerprints gets a key
    unique to this build (never None), so the next build rewrites it."""
    keys = []
    for block in assignment:
        for j in range(per_dev):
            if j < len(block):
                pk = getattr(segments[block[j]], "placement_key", None)
                if callable(pk):
                    keys.append(pk())
                else:
                    k = ("opaque", version, len(keys))
                    keys.append((k, k))
            else:
                keys.append(None)
    return tuple(keys)


def _rows_compatible(segments: Sequence, prev: SegmentPlacement) -> bool:
    """Every segment's rows fit ``prev``'s blocks (leaf dtypes and
    trailing shapes)."""
    blk = prev.blocks[0]
    for seg in segments:
        for row, stacked in ((seg.state.table, blk.table),
                             (seg.state.db, blk.db), (seg.gids, blk.gids),
                             (seg.live, blk.live)):
            if row.dtype != stacked.dtype or \
                    tuple(row.shape) != tuple(stacked.shape[1:]):
                return False
    return True


def _seg_row_bytes(seg, quantized: bool) -> int:
    """Bytes one full slot write moves for ``seg``."""
    return (seg.state.table.nbytes + seg.state.db.nbytes + seg.gids.nbytes
            + seg.live.nbytes + (4 if quantized else 0))


def _stacked_bytes(blocks: Sequence[RankBlock]) -> int:
    return sum(b.nbytes() for b in blocks)


def delta_on(delta, device: torch.device):
    """The delta segment as rank 0 scores it: itself on its own device, a
    copy of its leaves elsewhere."""
    if delta is None or delta.gids.device == device:
        return delta
    return dataclasses.replace(
        delta, state=dataclasses.replace(
            delta.state, table=delta.state.table.to(device),
            db=delta.state.db.to(device)),
        gids=delta.gids.to(device), live=delta.live.to(device))


def place_segments(segments: Sequence, delta, mesh, axis: str, version: int,
                   *, replication, prev: Optional[SegmentPlacement],
                   db_dtype: torch.dtype, quantized: bool,
                   delta_version: int) -> SegmentPlacement:
    """A :class:`SegmentPlacement` of ``segments`` (the live sealed
    segments, their positions what ``assignment`` refers to) and ``delta``
    over ``mesh``'s ``axis`` at ``version``.

    ``replication``: factors (None / int / sequence,
    :func:`normalize_replication`); ``prev``: the placement this replaces,
    or None -- when its mesh, axis and stripe width still serve and every
    row fits, only changed slots are written; ``db_dtype``: the tier's
    storage dtype (the rank blocks' db, padding rows too);
    ``quantized``: blocks carry one scale an instance (a sealed segment of
    a quantized tier always has one); ``delta_version``: the index's
    mutation count the delta is taken at."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, no {axis!r}")
    lay = layout_dict(mesh, axis, len(segments), replication=replication)
    n_dev, assignment = lay["n_dev"], lay["assignment"]
    same_mesh = (prev is not None and prev.mesh == mesh
                 and prev.axis == axis and prev.n_dev == n_dev)
    per_dev = headroom(lay["per_dev"], prev.per_dev if same_mesh else 0)
    keys = _slot_key_table(segments, assignment, per_dev, version)
    ranks = tuple(mesh.devices)
    if (same_mesh and prev.per_dev == per_dev
            and len(prev.slot_keys) == n_dev * per_dev
            and prev.quantized == quantized
            and all(callable(getattr(s, "placement_key", None))
                    for s in segments)
            and _rows_compatible(segments, prev)):
        return _place_diff(prev, segments, delta, version, lay, per_dev,
                           keys, delta_version)
    # a full (re)stack: the first build, a new mesh or stripe width
    table_shape = tuple(delta.state.table.shape)
    cap, n = delta.state.db.shape
    blocks = []
    for d in range(n_dev):
        dev = ranks[d]
        blk = RankBlock(
            device=dev,
            table=torch.full((per_dev, *table_shape), -1, dtype=torch.int32,
                             device=dev),
            db=torch.zeros((per_dev, cap, n), dtype=db_dtype, device=dev),
            gids=torch.full((per_dev, cap), -1, dtype=torch.int32,
                            device=dev),
            live=torch.zeros((per_dev, cap), dtype=torch.bool, device=dev),
            scale=(torch.ones((per_dev,), dtype=torch.float32, device=dev)
                   if quantized else None))
        for j, si in enumerate(assignment[d]):
            _write_row(blk, j, segments[si])
        blocks.append(blk)
    total = _stacked_bytes(blocks)
    return SegmentPlacement(
        mesh=mesh, axis=axis, n_dev=n_dev, per_dev=per_dev,
        n_sealed=len(segments), version=version, blocks=tuple(blocks),
        assignment=tuple(tuple(a) for a in assignment),
        replication=tuple(lay["replication"]),
        delta=delta_on(delta, ranks[0]), delta_version=delta_version,
        slot_keys=keys, replaced_bytes=total, sealed_bytes=total,
        diffed=False)


def _write_row(blk: RankBlock, j: int, seg) -> None:
    """Copy ``seg``'s leaves into row ``j`` of ``blk`` (across devices
    when they differ)."""
    blk.table[j].copy_(seg.state.table)
    blk.db[j].copy_(seg.state.db)
    blk.gids[j].copy_(seg.gids)
    blk.live[j].copy_(seg.live)
    if blk.scale is not None:
        blk.scale[j].copy_(seg.scale)


def _place_diff(prev: SegmentPlacement, segments: Sequence, delta,
                version: int, lay: dict, per_dev: int, keys: tuple,
                delta_version: int) -> SegmentPlacement:
    """Rewrite only the slots whose fingerprint changed, in place in
    ``prev``'s blocks: an unchanged fingerprint moves 0 bytes; the same
    content with another live mask rewrites the mask row; anything else the
    whole row.  A freed slot gets gids -1 and an all-dead live row (its
    stale table and db stay, unreachable, as padding's are).

    Writing in place is safe: every query reads the placement under the
    index lock, and on the card its kernels are enqueued on the same
    stream before the writes."""
    n_dev, assignment = lay["n_dev"], lay["assignment"]
    replaced = 0
    for slot, (key, old) in enumerate(zip(keys, prev.slot_keys)):
        if key == old:
            continue
        blk, j = prev.blocks[slot // per_dev], slot % per_dev
        if key is None:
            blk.gids[j] = -1
            blk.live[j] = False
            replaced += blk.gids[j].nbytes + blk.live[j].nbytes
            continue
        seg = segments[assignment[slot // per_dev][j]]
        if old is not None and key[0] == old[0]:
            blk.live[j].copy_(seg.live)
            replaced += seg.live.nbytes
            continue
        _write_row(blk, j, seg)
        replaced += _seg_row_bytes(seg, blk.scale is not None)
    return dataclasses.replace(
        prev, n_sealed=len(segments), version=version,
        assignment=tuple(tuple(a) for a in assignment),
        replication=tuple(lay["replication"]),
        delta=delta_on(delta, prev.blocks[0].device),
        delta_version=delta_version, slot_keys=keys,
        replaced_bytes=replaced, sealed_bytes=_stacked_bytes(prev.blocks),
        diffed=True)


def refresh_delta(pl: SegmentPlacement, delta,
                  delta_version: int) -> SegmentPlacement:
    """The placement with only its delta re-taken (a delta-only mutation:
    an insert that does not seal, a delete in the delta): O(delta bytes)
    when rank 0 lies on another device, nothing when it is the index's."""
    return dataclasses.replace(pl, delta=delta_on(delta, pl.blocks[0].device),
                               delta_version=delta_version)
