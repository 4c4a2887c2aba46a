"""Servable registry: named endpoints over segmented indexes.

The port of ``repro/serve/registry.py``.  A
:class:`ServableSpec` is the declarative tenant config; a
:class:`Servable` is the live endpoint (embedder + segmented index +
micro-batcher + stats); the :class:`ServableRegistry` maps names to
servables and owns durability:

* ``wal_dir``: every tenant logs its mutations to ``<wal_dir>/<name>.wal``
  (``serve/wal.py``), which opens with a REGISTER record of its spec;
* ``snapshot`` / ``restore``: per-tenant checkpoints (``checkpoint/``)
  under ``<root>/<name>/step_*``, whose tree and manifest are the JAX
  package's, so either package restores the other's snapshots;
* ``recover``: the newest verifiable snapshot plus a replay of the WAL
  tail -- the answers of the run that never crashed (invariant 7);
* ``adopt``: a tenant from another process's REGISTER record, verbatim
  (the warm standby, ``serve/standby.py``).

``register`` resolves the storage tier once (``dispatch.store_dtype``:
``$REPRO_STORE_DTYPE`` wins over the spec), and the resolved tier is what
the REGISTER record and every snapshot carry.

The hash family comes from ``torch.Generator().manual_seed(spec.seed)``;
it cannot match the JAX package's ``jax.random.PRNGKey(spec.seed)`` draw,
so ``family=`` injects one (tests hand both packages the same arrays).  A
snapshot carries its family in its segments; a REGISTER record carries
none, so a tenant rebuilt from the log alone draws it from its seed again
(the JAX package's logs replay with ``SegmentedIndex.replay`` into an index
built with the injected family).

Placement, as the JAX registry's: a registry built with ``mesh=`` (a
``launch.mesh.ServeMesh``) shards every tenant whose ``shard_axis`` names
the mesh's axis, and applies a ``static:k`` replication policy at
registration (``auto`` starts unreplicated and re-places at each
compaction, ``ServableMaintenance``); tenants without a shard axis stay on
the registry's device.  ``report()`` and every snapshot carry the
tenant's ``shard_layout``; ``restore`` and ``recover`` re-place a tenant
onto the restoring registry's mesh, whatever its size (or none).

Telemetry, as the JAX registry's: each servable's stats, index and
batcher publish under its name as the ``tenant`` label, ``embed`` runs
under an ``embed`` span, ``report()`` carries the registry's
``"metrics"`` summary of the tenant, and ``recover`` runs each restore
under ``recover.restore`` and each replay under ``recover.replay``,
counting ``recovery_restores_total`` and
``recovery_replayed_records_total``.

The network front-end's tenant lifecycle, as the JAX registry's:
``log_lifecycle`` counts ``tenant_lifecycle_transitions_total`` and appends
a synced LIFECYCLE record to the tenant's WAL (recovery and the standby
skip a tenant whose log ends "unloaded"); ``unregister`` drops the tenant
and stops its batcher's pump thread, after which nothing of the registry
holds its tensors.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt
from ..checkpoint.checkpoint import ArraySpec
from ..core.index import IndexConfig, LSHIndexState
from ..embedders import embedder_names, make_embedder
from ..kernels import dispatch, quantize
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import faults, wal as walmod
from .batcher import MicroBatcher
from .maintenance import ServableMaintenance
from .segments import Segment, SegmentedIndex
from .stats import ServingStats, occupancy_report, store_report


@dataclasses.dataclass(frozen=True)
class ServableSpec:
    """Declarative tenant config (everything needed to rebuild it)."""

    name: str
    n_dims: int = 64
    p: float = 2.0                 # l_p of the p-stable family, (0, 2]
    r: float = 1.0                 # quantisation width (Eq. 5)
    n_tables: int = 8
    n_hashes: int = 4
    log2_buckets: int = 10
    bucket_capacity: int = 32
    embedder: str = "basis"        # a repro_torch.embedders name
    embedder_params: Optional[Dict[str, Any]] = None
    volume: float = 1.0
    segment_capacity: int = 1024
    insert_chunk: int = 256
    chunk_sizes: Tuple[int, ...] = (8, 32, 128)
    max_delay_ms: float = 5.0
    seed: int = 0
    # the mesh axis to shard over (None: one device); with a registry mesh
    # carrying that axis the tenant's sealed segments spread over its ranks
    shard_axis: Optional[str] = None
    # hot-segment replication across the mesh: "none" | "static:k" (every
    # sealed segment on k ranks) | "auto" (factors from shard_balance at
    # every compaction, serve.router.auto_factors)
    replication: str = "none"
    # sealed-segment storage tier: "fp32" (exact, the default) | "bf16" |
    # "int8" (bounded-loss, survivor-reranked)
    precision: str = "fp32"
    # survivor-pool width m of the quantized query (0 = the default 4k;
    # ``kernels.quantize.survivor_width``)
    survivor_k: int = 0

    def __post_init__(self):
        if self.embedder not in embedder_names():
            raise ValueError(f"embedder must be one of {embedder_names()}")
        if self.precision not in dispatch.STORE_DTYPES:
            raise ValueError(
                f"precision must be one of {dispatch.STORE_DTYPES}, "
                f"got {self.precision!r}")
        self.replication_policy()    # fail fast on a malformed policy

    def replication_policy(self):
        """The replication field parsed: None, an int k >= 1, or
        ``"auto"``."""
        rep = self.replication
        if rep in ("none", None):
            return None
        if rep == "auto":
            return "auto"
        if isinstance(rep, str) and rep.startswith("static:"):
            try:
                k = int(rep.split(":", 1)[1])
            except ValueError:
                k = 0
            if k >= 1:
                return k
        raise ValueError(
            f"replication must be 'none', 'static:k' or 'auto', got {rep!r}")

    def index_config(self) -> IndexConfig:
        return IndexConfig(n_dims=self.n_dims, n_tables=self.n_tables,
                           n_hashes=self.n_hashes,
                           log2_buckets=self.log2_buckets,
                           bucket_capacity=self.bucket_capacity,
                           r=self.r, p=self.p)


def _spec_from_manifest(raw: Dict[str, Any]) -> ServableSpec:
    """A ServableSpec from a manifest's or a REGISTER record's dict:
    unknown keys are dropped (a newer build's spec still restores) and
    JSON lists are re-tupled where the dataclass wants tuples."""
    known = {f.name for f in dataclasses.fields(ServableSpec)}
    kw = {k: v for k, v in raw.items() if k in known}
    if "chunk_sizes" in kw:
        kw["chunk_sizes"] = tuple(kw["chunk_sizes"])
    return ServableSpec(**kw)


class Servable:
    """A live endpoint on ``device`` (default: the card; with no card and
    no explicit ``device="cpu"`` construction raises).  With a ``mesh``
    carrying ``spec.shard_axis`` the index is sharded over it."""

    def __init__(self, spec: ServableSpec, *, device=None, family=None,
                 mesh=None):
        self.spec = spec
        self.device = dispatch.resolve_device(device)
        self.embedder = make_embedder(spec.embedder, n_dims=spec.n_dims,
                                      p=spec.p, volume=spec.volume,
                                      params=spec.embedder_params,
                                      device=self.device)
        self.stats = ServingStats(tenant=spec.name)
        self.index = SegmentedIndex(spec.index_config(),
                                    segment_capacity=spec.segment_capacity,
                                    insert_chunk=spec.insert_chunk,
                                    seed=spec.seed, family=family,
                                    precision=spec.precision,
                                    survivor_k=spec.survivor_k,
                                    device=self.device, tenant=spec.name,
                                    on_fanout=self.stats.record_fanout)
        # the tenant's maintenance handle (seal, compact, replication);
        # the MaintenancePool is its background caller
        self.maintenance = ServableMaintenance(self)
        if spec.shard_axis is not None and mesh is not None \
                and spec.shard_axis in mesh.axis_names:
            self.index.shard(mesh, spec.shard_axis)
            policy = spec.replication_policy()
            if isinstance(policy, int):
                self.index.maintenance.set_replication(policy)
            # "auto" starts unreplicated and re-places at each compaction
        self.batcher = self.make_batcher(spec)

    def make_batcher(self, spec: ServableSpec) -> MicroBatcher:
        """A micro-batcher over this tenant's query path with ``spec``'s
        palette and deadline (the front-end's ``update`` builds its new
        one here too, so segment wins stay counted after an update)."""
        return MicroBatcher(self._raw_query, chunk_sizes=spec.chunk_sizes,
                            max_delay_ms=spec.max_delay_ms,
                            on_batch=self.stats.record_batch,
                            on_answer=self.index.fanout_telemetry,
                            tenant=spec.name)

    def embed(self, fvals) -> torch.Tensor:
        """Function samples (B, len(nodes())) -> (B, n_dims) embeddings on
        the device, through the padded ingest palette."""
        with obs_trace.tracer().span("embed", tenant=self.spec.name,
                                     rows=len(fvals),
                                     embedder=self.spec.embedder):
            return self.embedder.embed_batched(
                fvals, batch_size=max(self.spec.chunk_sizes))

    def nodes(self) -> np.ndarray:
        return self.embedder.nodes()

    def insert(self, embeddings, gids=None) -> np.ndarray:
        before = self.index.n_rejected
        try:
            out = self.index.insert(embeddings, gids=gids)
        except ValueError:
            self.stats.record_rejected(self.index.n_rejected - before)
            raise
        self.stats.record_insert(len(out))
        return out

    def delete(self, gids) -> int:
        n = self.index.delete(gids)
        self.stats.record_delete(n)
        return n

    def compact(self) -> int:
        """Deprecated: use ``servable.maintenance.compact()``."""
        warnings.warn(
            "Servable.compact() is deprecated; compact through the "
            "maintenance plane (servable.maintenance.compact())",
            DeprecationWarning, stacklevel=2)
        return self.maintenance.compact()

    def _raw_query(self, queries, k: int, n_probes: int):
        g, d = self.index.query(queries, k, n_probes=n_probes)
        return g.cpu().numpy(), d.cpu().numpy()

    def submit_query(self, queries, k: int, n_probes: int = 1):
        """Admission-queue path: a Future of (gids, dists) numpy arrays."""
        return self.batcher.submit(queries, k, n_probes)

    def query(self, queries, k: int, n_probes: int = 1):
        """Synchronous path, through the same padded batches."""
        return self.batcher.query(queries, k, n_probes)

    def report(self) -> dict:
        occ = occupancy_report(self.index)
        occ.pop("segments")
        return {"spec": dataclasses.asdict(self.spec),
                "device": str(self.device),
                "embedder": self.embedder.describe(),
                "stats": self.stats.snapshot(),
                "batcher": {"unique_shapes": self.batcher.unique_shapes(),
                            "n_batches": self.batcher.n_batches,
                            "n_requests": self.batcher.n_requests},
                "occupancy": occ,
                "shard_layout": self.index.shard_layout(),
                "store": store_report(self.index),
                # the registry's view of this tenant: the names the
                # exporter emits
                "metrics": obs_metrics.registry().summary(
                    tenant=self.spec.name)}


class ServableRegistry:
    """Name -> Servable map; every tenant lives on ``device``, and those
    whose spec names ``mesh``'s axis are sharded over it.

    ``wal_dir``: when set, each tenant logs every mutation to
    ``<wal_dir>/<name>.wal`` before applying it, and :meth:`recover`
    replays snapshot + WAL tail after a crash.  ``fsync_every``: the WAL's
    group-commit interval (default ``$REPRO_WAL_FSYNC_EVERY``, 8).
    """

    def __init__(self, *, device=None, mesh=None,
                 wal_dir: Optional[str] = None,
                 fsync_every: Optional[int] = None):
        self.device = dispatch.resolve_device(device)
        self.mesh = mesh
        self._servables: Dict[str, Servable] = {}
        self._wal_dir = wal_dir
        self._fsync_every = fsync_every
        self._lock = threading.Lock()

    def _wal_path(self, name: str) -> Optional[str]:
        return (os.path.join(self._wal_dir, f"{name}.wal")
                if self._wal_dir else None)

    def register(self, spec: ServableSpec, family=None) -> Servable:
        """Build the tenant.  Its storage tier is resolved here, once
        (``$REPRO_STORE_DTYPE`` wins); with a ``wal_dir`` its log opens
        with the resolved spec's REGISTER record, synced, so recovery
        without a snapshot can rebuild it."""
        resolved = dispatch.store_dtype(spec.precision)
        if resolved != spec.precision:
            spec = dataclasses.replace(spec, precision=resolved)
        with self._lock:
            sv = self._register(spec, family)
            wpath = self._wal_path(spec.name)
            if wpath is not None:
                wal = walmod.WriteAheadLog(wpath,
                                           fsync_every=self._fsync_every)
                wal.append(walmod.encode_register(dataclasses.asdict(spec)))
                wal.sync()
                sv.index.attach_wal(wal)
            return sv

    def _register(self, spec: ServableSpec, family=None) -> Servable:
        """Build and record the servable (callers hold the lock; no WAL)."""
        if spec.name in self._servables:
            raise ValueError(f"servable {spec.name!r} already registered")
        sv = Servable(spec, device=self.device, family=family,
                      mesh=self.mesh)
        self._servables[spec.name] = sv
        return sv

    def adopt(self, spec: ServableSpec, family=None) -> Servable:
        """Register a tenant from a spec already resolved and logged by
        another process (the warm standby): the tier is not re-resolved and
        nothing is written to any WAL."""
        with self._lock:
            return self._register(spec, family)

    def _drop(self, name: str) -> None:
        with self._lock:
            self._servables.pop(name, None)

    def get(self, name: str) -> Servable:
        try:
            return self._servables[name]
        except KeyError:
            raise KeyError(f"no servable {name!r}; have {self.names()}")

    def log_lifecycle(self, name: str, state: str) -> None:
        """Count the transition (``tenant_lifecycle_transitions_total``)
        and append a LIFECYCLE record to the tenant's WAL, synced at once:
        an unloaded tenant must not come back because its record was still
        in the group-commit window when the process died.  Replay treats
        the record as a no-op; ``recover`` skips a tenant whose log ends
        "unloaded"."""
        obs_metrics.registry().inc("tenant_lifecycle_transitions_total",
                                   tenant=name, state=state)
        sv = self._servables.get(name)
        wal = sv.index.wal if sv is not None else None
        if wal is not None:
            wal.append(walmod.encode_lifecycle(state))
            wal.sync()

    def unregister(self, name: str) -> None:
        """Drop the tenant and stop its batcher's pump thread (queued
        requests are flushed first)."""
        with self._lock:
            sv = self._servables.pop(name, None)
            if sv is not None:
                sv.batcher.stop()

    def names(self) -> List[str]:
        return sorted(self._servables)

    def report(self) -> dict:
        return {name: sv.report() for name, sv in
                sorted(self._servables.items())}

    # -- persistence --------------------------------------------------------

    def snapshot(self, root: str, step: int = 0, keep: int = 3) -> str:
        """Atomic per-tenant checkpoints under ``root/<name>/step_*``.

        The tree is the JAX package's: ``{"segments": [{"state": [alpha,
        b, mix (uint32), table, counts, db], "gids", "live"}, ...]}``, a
        quantized sealed segment adding its ``scale`` and fp32 survivor
        ``pool``; the manifest's ``extra`` holds the spec, ``next_gid`` and
        each segment's counts.  A WAL-backed tenant also syncs its log and
        records the offset (``wal_offset``) replay resumes from.  Tensors
        are copied to the host under the index lock (so the arrays, the
        counters and the offset describe one instant) and written with no
        lock held."""
        for name, sv in list(self._servables.items()):
            idx = sv.index
            # per-tenant crash point: some tenants snapshotted, others not
            faults.fire("snapshot")
            with idx._lock:
                tree = {"segments": [_segment_tree(seg)
                                     for seg in idx.segments]}
                extra = {
                    "spec": dataclasses.asdict(sv.spec),
                    "next_gid": idx._next_gid,
                    "segments": [{"n_items": s.n_items, "n_live": s.n_live,
                                  "sealed": s.sealed,
                                  "quantized": s.scale is not None}
                                 for s in idx.segments],
                    # for reports only: restore re-places from the spec
                    # and the restoring registry's mesh
                    "shard_layout": idx.shard_layout(),
                }
                if idx.wal is not None:
                    idx.wal.sync()
                    extra["wal_offset"] = idx.wal.offset
                host = ckpt.to_host(tree)
            ckpt.save_host(os.path.join(root, name), step, host, keep=keep,
                           extra=extra)
        return root

    def restore(self, root: str, step: Optional[int] = None) -> List[str]:
        """Load every tenant checkpoint under ``root`` (its newest step, or
        ``step``); returns the restored names.  No WAL replay: ``recover``
        is the crash path."""
        restored = []
        for name in sorted(os.listdir(root)):
            tdir = os.path.join(root, name)
            if not os.path.isdir(tdir):
                continue
            s = ckpt.latest_step(tdir) if step is None else step
            if s is None:
                continue
            self._restore_tenant(tdir, s)
            restored.append(name)
        return restored

    def _restore_tenant(self, tdir: str, s: int) -> Servable:
        """Rebuild one tenant from checkpoint step ``s`` (integrity-checked:
        raises CheckpointCorruptError on damage, and the half-built tenant
        is dropped)."""
        extra = ckpt.load_extra(tdir, s)
        spec = _spec_from_manifest(extra["spec"])
        with self._lock:
            sv = self._register(spec)
        seg_meta = extra["segments"]
        try:
            # read on the host: the pool stays there, mix widens to int64
            tree = ckpt.restore(tdir, s, {"segments": [
                _segment_target(spec, m.get("quantized", False))
                for m in seg_meta]}, device="cpu")
        except BaseException:
            self._drop(spec.name)
            raise
        dev = self.device
        segments = []
        for payload, meta in zip(tree["segments"], seg_meta):
            alpha, b, mix, table, counts, db = payload["state"]
            scale = payload.get("scale")
            segments.append(Segment(
                state=LSHIndexState(
                    alpha=alpha.to(dev), b=b.to(dev),
                    mix=mix.to(torch.int64).to(dev), table=table.to(dev),
                    counts=counts.to(dev), db=db.to(dev)),
                gids=payload["gids"].to(dev), live=payload["live"].to(dev),
                n_items=meta["n_items"], n_live=meta["n_live"],
                sealed=meta["sealed"],
                scale=None if scale is None else scale.to(dev),
                pool=(payload["pool"].numpy() if "pool" in payload
                      else None)))
        # the family is segment 0's (alpha, b, mix), as the JAX package's
        sv.index.load_segments(segments, extra["next_gid"])
        return sv

    def recover(self, ckpt_root: Optional[str] = None,
                wal_dir: Optional[str] = None,
                replay_from: str = "offset") -> Dict[str, dict]:
        """Crash recovery: the newest verifiable snapshot + a WAL replay.

        For every tenant under ``ckpt_root`` and/or ``wal_dir``:

        1. restore the newest checkpoint step that passes its checks -- a
           corrupt step is reported and the next older one tried;
        2. with no usable snapshot, rebuild it from its log's REGISTER
           record and replay from byte 0;
        3. replay the WAL from the snapshot's ``wal_offset``
           (``replay_from="offset"``) or from the start (``"start"``:
           replayed inserts drop by gid, the rest is idempotent);
        4. cut a torn or corrupt tail off the log and reattach it, so the
           recovered tenant keeps logging to the same file.

        A tenant whose log ends in an "unloaded" LIFECYCLE record is
        skipped.  Returns per-tenant reports: the replay report plus
        ``restored_step`` and ``corrupt_steps``."""
        if replay_from not in ("offset", "start"):
            raise ValueError(f"replay_from must be 'offset' or 'start', "
                             f"got {replay_from!r}")
        wal_dir = wal_dir if wal_dir is not None else self._wal_dir
        names = set()
        if ckpt_root and os.path.isdir(ckpt_root):
            names.update(n for n in os.listdir(ckpt_root)
                         if os.path.isdir(os.path.join(ckpt_root, n)))
        if wal_dir and os.path.isdir(wal_dir):
            names.update(n[:-len(".wal")] for n in os.listdir(wal_dir)
                         if n.endswith(".wal"))
        reports: Dict[str, dict] = {}
        for name in sorted(names):
            report: dict = {"restored_step": None, "corrupt_steps": []}
            wpath = os.path.join(wal_dir, f"{name}.wal") if wal_dir else None
            has_wal = wpath is not None and os.path.exists(wpath)
            if has_wal and walmod.read_last_lifecycle(wpath) == "unloaded":
                # detached on purpose, not lost in the crash
                reports[name] = dict(report, skipped="unloaded")
                continue
            sv, offset = None, 0
            tdir = os.path.join(ckpt_root, name) if ckpt_root else None
            tr = obs_trace.tracer()
            reg = obs_metrics.registry()
            if tdir is not None and os.path.isdir(tdir):
                for s in reversed(ckpt.steps(tdir)):
                    try:
                        with tr.span("recover.restore", tenant=name, step=s):
                            sv = self._restore_tenant(tdir, s)
                    except ckpt.CheckpointCorruptError as e:
                        report["corrupt_steps"].append([s, str(e)])
                        continue
                    offset = int(ckpt.load_extra(tdir, s).get("wal_offset",
                                                              0))
                    report["restored_step"] = s
                    reg.inc("recovery_restores_total", tenant=name)
                    break
            if sv is None:
                if not has_wal:
                    continue               # nothing restorable for it
                raw = walmod.read_spec(wpath)
                if raw is None:
                    report["error"] = "no snapshot and no REGISTER record"
                    reports[name] = report
                    continue
                with self._lock:
                    sv = self._register(_spec_from_manifest(raw))
                offset = 0
            if has_wal:
                start = 0 if replay_from == "start" else offset
                with tr.span("recover.replay", tenant=name, start=start):
                    rep = sv.index.replay(wpath, start=start)
                reg.inc("recovery_replayed_records_total",
                        int(rep.get("n_records", 0)), tenant=name)
                report.update(rep)
                if rep["truncated"]:
                    # appends behind a bad frame would be invisible to
                    # every later replay
                    with open(wpath, "rb+") as f:
                        f.truncate(rep["end_offset"])
                    report["truncated_to"] = rep["end_offset"]
                sv.index.attach_wal(walmod.WriteAheadLog(
                    wpath, fsync_every=self._fsync_every))
            reports[name] = report
        return reports


def _segment_tree(seg: Segment) -> dict:
    """One segment's snapshot leaves, the JAX package's tree."""
    st = seg.state
    tree = {"state": [st.alpha, st.b,
                      st.mix.cpu().numpy().astype(np.uint32), st.table,
                      st.counts, st.db],
            "gids": seg.gids, "live": seg.live}
    if seg.scale is not None:
        tree["scale"] = seg.scale
        tree["pool"] = seg.pool
    return tree


def _segment_target(spec: ServableSpec, quantized: bool) -> dict:
    """:func:`_segment_tree`'s shapes and dtypes, for ``ckpt.restore``: a
    quantized sealed segment holds codes, a scale and the fp32 pool."""
    cfg = spec.index_config()
    cap, n = spec.segment_capacity, spec.n_dims
    lk = cfg.n_tables * cfg.n_hashes
    db_dt = (quantize.storage_dtype(spec.precision) if quantized
             else torch.float32)
    target = {
        "state": [ArraySpec((n, lk), torch.float32),
                  ArraySpec((lk,), torch.float32),
                  ArraySpec((cfg.n_tables, cfg.n_hashes), torch.uint32),
                  ArraySpec((cfg.n_tables, cfg.n_buckets,
                             cfg.bucket_capacity), torch.int32),
                  ArraySpec((cfg.n_tables, cfg.n_buckets), torch.int32),
                  ArraySpec((cap, n), db_dt)],
        "gids": ArraySpec((cap,), torch.int32),
        "live": ArraySpec((cap,), torch.bool),
    }
    if quantized:
        target["scale"] = ArraySpec((), torch.float32)
        target["pool"] = ArraySpec((cap, n), torch.float32)
    return target
