"""The maintenance plane: seal, compact and re-placement off the query path.

The port of ``repro/serve/maintenance.py``:

* :class:`IndexMaintenance` -- the per-index handle (``index.maintenance``)
  that owns ``seal()``, ``compact()`` and ``set_replication()``; a
  per-index mutex runs one
  maintenance operation at a time (insert, delete and query are guarded by
  the index's own lock), so a seal can never interleave with the freeze,
  build and swap of a compaction.  ``SegmentedIndex.seal``,
  ``.compact`` and ``.set_replication`` remain as ``DeprecationWarning``
  shims over it.
* :class:`ServableMaintenance` -- the per-tenant handle
  (``servable.maintenance``): the index handle plus what the serve layer
  adds -- under ``replication="auto"`` each compaction re-places from the
  fan-out telemetry (``router.auto_factors`` over ``shard_balance``'s
  segment wins, then ``reset_fanout``), and every operation ends with
  ``refresh_placement()``, so a sharded tenant's placement diff is paid on
  the maintenance thread, not by the next query.
* :class:`MaintenancePool` -- background workers: jobs queued per tenant,
  run on daemon threads and polled by id.

Queries are not blocked by a compaction's costly phase: the shadow build
takes no lock, and the swap publishes it under the index lock (invariant
11 of the JAX package, "maintenance is invisible").  Worker and query
threads launch their kernels on the same (default) stream of the index's
card, so the shadow's tensors are complete, in stream order, before any
query that the swap lets read them.

With a WAL attached, ``seal()`` logs a SEAL record (then the ``seal``
fault site) and ``compact()``'s freeze a COMPACT record (then
``compact.freeze``; ``compact.swap`` fires before the swap), so a replay
re-runs them (``SegmentedIndex._maint_seal`` / ``_compact_freeze``).

The pool publishes, as the JAX pool: ``maintenance_queue_depth`` (jobs
queued or running) at each submit and each job's end, and at each job's
end ``maintenance_jobs_total{tenant, kind, status}`` and
``maintenance_job_latency_s{tenant, kind}`` (dequeue to completion),
before the job reads as done, so a caller that waited sees them.

The wire ``maintenance`` verb (``serve/frontend.py``) maps onto
:meth:`MaintenancePool.submit` and ``job_status`` onto
:meth:`MaintenancePool.status`; the kinds are the protocol's
``MAINTENANCE_KINDS``: ``seal``, ``compact`` and ``set_replication``
(param ``replication``: None, an int or factors per sealed segment).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import threading
import time
import traceback
from typing import Any, Dict, Optional

from ..obs import metrics as obs_metrics
from .router import auto_factors

#: job kinds the pool (and the wire ``maintenance`` verb) accepts
KINDS = ("seal", "compact", "set_replication")


class IndexMaintenance:
    """Maintenance handle for one ``SegmentedIndex``: each method calls the
    index's ``_maint_*`` entry point under this handle's mutex."""

    def __init__(self, index):
        self._index = index
        self._mutex = threading.Lock()

    def seal(self) -> None:
        """Seal the current delta (no-op if empty)."""
        with self._mutex:
            self._index._maint_seal()

    def compact(self) -> int:
        """Freeze, build the shadow (no lock), swap.  Returns the number of
        segments after the compaction."""
        with self._mutex:
            return self._index._maint_compact()

    def set_replication(self, replication) -> None:
        """Set the sealed-segment replication policy (WAL-logged)."""
        with self._mutex:
            self._index._maint_set_replication(replication)


class ServableMaintenance:
    """Maintenance handle for one ``Servable`` (tenant); each operation
    ends with the index's ``refresh_placement()``."""

    def __init__(self, servable):
        self._sv = servable

    @property
    def index(self) -> IndexMaintenance:
        return self._sv.index.maintenance

    def seal(self) -> int:
        """Seal the tenant's delta; returns the number of segments."""
        self.index.seal()
        self._sv.index.refresh_placement()
        return len(self._sv.index.segments)

    def compact(self) -> int:
        """Compact the tenant's index; returns the number of segments.
        Under ``replication="auto"`` on a sharded tenant, the factors are
        taken from the segment wins since the last re-placement (the
        trailing slot, the delta's at record time, left out) and set after
        the compaction; wins attach to positions, which a gid-order repack
        roughly keeps."""
        sv = self._sv
        factors = None
        lay = sv.index.shard_layout()
        if sv.spec.replication_policy() == "auto" and lay is not None:
            wins = sv.stats.shard_balance()["per_segment_wins"]
            factors = auto_factors(wins[:-1], lay["n_dev"])
        n = self.index.compact()
        if factors is not None:
            self.index.set_replication(factors)
            sv.stats.reset_fanout()
        sv.index.refresh_placement()
        return n

    def set_replication(self, replication) -> None:
        """Set the tenant's replication policy and re-place now."""
        self.index.set_replication(replication)
        self._sv.index.refresh_placement()


@dataclasses.dataclass
class MaintenanceJob:
    """One queued maintenance operation, pollable by id."""

    job_id: str
    tenant: str
    kind: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "queued"        # queued | running | done | failed
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    traceback: Optional[str] = None
    submitted_s: float = 0.0      # time.monotonic() at submit
    finished_s: float = 0.0       # and at the job's end

    def to_dict(self) -> dict:
        out = {"job_id": self.job_id, "tenant": self.tenant,
               "kind": self.kind, "status": self.status}
        if self.result is not None:
            out["result"] = self.result
        if self.error is not None:
            out["error"] = self.error
            out["traceback"] = self.traceback
        return out


class MaintenancePool:
    """Background maintenance workers over a ``ServableRegistry``.

    A FIFO job queue drained by ``workers`` daemon threads (None reads
    ``$REPRO_MAINT_WORKERS``, default 1).  A per-tenant
    lock keeps at most one job per tenant running even with several
    workers; different tenants' jobs run at once.  A tenant is looked up
    when its job runs, so a job for an unknown tenant fails with a
    structured error and the worker goes on.
    """

    def __init__(self, registry, workers: Optional[int] = None):
        self._registry = registry
        if workers is None:
            workers = int(os.environ.get("REPRO_MAINT_WORKERS", "1"))
        self.workers = max(1, int(workers))
        self._queue: "queue.Queue" = queue.Queue()
        self._jobs: Dict[str, MaintenanceJob] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tenant_locks: Dict[str, threading.Lock] = {}
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"maint-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # -- submission / polling -----------------------------------------------

    def submit(self, tenant: str, kind: str, **params) -> str:
        """Queue one job; returns its id at once (poll with
        :meth:`status`).  ``params`` are kept on the job (``seal`` and
        ``compact`` read none, ``set_replication`` its ``replication``).
        Raises ValueError on an unknown kind (the wire layer answers
        ``bad_request``) and RuntimeError once the pool is stopped."""
        if kind not in KINDS:
            raise ValueError(f"unknown maintenance kind {kind!r}; want one "
                             f"of {KINDS}")
        if self._stop.is_set():
            raise RuntimeError("maintenance pool is stopped")
        with self._lock:
            job = MaintenanceJob(job_id=f"mj-{next(self._ids)}",
                                 tenant=str(tenant), kind=kind,
                                 params=dict(params),
                                 submitted_s=time.monotonic())
            self._jobs[job.job_id] = job
        self._set_depth()
        self._queue.put(job.job_id)
        return job.job_id

    def status(self, job_id: str) -> Optional[dict]:
        """The job's state as a dict, or None for an unknown id."""
        with self._lock:
            job = self._jobs.get(job_id)
            return None if job is None else job.to_dict()

    def wait(self, job_id: str, timeout_s: float = 30.0,
             interval_s: float = 0.005) -> dict:
        """Block until the job is done or failed; raises TimeoutError after
        ``timeout_s`` and KeyError for an unknown id."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = self.status(job_id)
            if st is None:
                raise KeyError(f"unknown maintenance job {job_id!r}")
            if st["status"] in ("done", "failed"):
                return st
            time.sleep(interval_s)
        raise TimeoutError(f"maintenance job {job_id} still "
                           f"{self.status(job_id)['status']} after "
                           f"{timeout_s}s")

    def drain(self, timeout_s: float = 30.0) -> None:
        """Wait until every submitted job is done or failed, at most
        ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(j.status in ("queued", "running")
                           for j in self._jobs.values())
            if not busy:
                return
            time.sleep(0.005)

    def stop(self, timeout_s: float = 30.0) -> None:
        """Drain the jobs, then stop the workers.  Idempotent."""
        if self._stop.is_set():
            return
        self.drain(timeout_s)
        self._stop.set()
        for _ in self._threads:
            self._queue.put(None)           # one wake-up per worker
        for t in self._threads:
            t.join(timeout=timeout_s)

    # -- workers ------------------------------------------------------------

    def _tenant_lock(self, tenant: str) -> threading.Lock:
        with self._lock:
            return self._tenant_locks.setdefault(tenant, threading.Lock())

    def _set_depth(self) -> None:
        """Publish the jobs queued or running (the registry's lock is taken
        after the pool's is released)."""
        with self._lock:
            depth = sum(1 for j in self._jobs.values()
                        if j.status in ("queued", "running"))
        obs_metrics.registry().set("maintenance_queue_depth", depth)

    def _worker(self) -> None:
        while True:
            job_id = self._queue.get()
            if job_id is None:              # stop()'s wake-up
                return
            with self._lock:
                job = self._jobs[job_id]
                job.status = "running"
            result, error, tb = None, None, None
            t0 = time.monotonic()
            try:
                with self._tenant_lock(job.tenant):
                    result = self._run(job)
            except Exception as e:  # noqa: BLE001 -- a failed job must
                # not end the worker; the job keeps the error and traceback
                error = f"{type(e).__name__}: {e}"
                tb = traceback.format_exc()
            status = "failed" if error is not None else "done"
            reg = obs_metrics.registry()
            reg.inc("maintenance_jobs_total", tenant=job.tenant,
                    kind=job.kind, status=status)
            reg.observe("maintenance_job_latency_s", time.monotonic() - t0,
                        tenant=job.tenant, kind=job.kind)
            with self._lock:
                job.result, job.error, job.traceback = result, error, tb
                job.finished_s = time.monotonic()
                job.status = status
            self._set_depth()

    def _run(self, job: MaintenanceJob) -> dict:
        sv = self._registry.get(job.tenant)
        if job.kind == "seal":
            return {"n_segments": int(sv.maintenance.seal())}
        if job.kind == "compact":
            n = sv.maintenance.compact()
            return {"n_segments": int(n), "n_live": int(sv.index.n_live)}
        replication = job.params.get("replication")
        if replication is not None and not isinstance(replication, int):
            replication = tuple(int(f) for f in replication)
        sv.maintenance.set_replication(replication)
        return {"replication": job.params.get("replication")}
