"""WAL-shipping warm standby: continuous replay, promotion on demand.

The port of ``repro/serve/standby.py`` on one device.  Recovery
(``ServableRegistry.recover``) replays a tenant's log after the primary
died, while the endpoint is dark.  A :class:`WalStandby` replays it while
the primary is alive: it tails the primary's per-tenant WAL files into its
own :class:`ServableRegistry` through the index's idempotent replay core
(``SegmentedIndex.apply_records``).  When the primary dies,
:meth:`promote` has almost nothing left to replay: one last poll, the torn
tail cut, the logs attached for appending -- and the standby's registry
answers as the uninterrupted primary would.

* The standby reads the directory the primary writes.  ``WalFollower``
  gives each tenant a cursor that stops before a torn tail and retries it
  on the next poll: an append in progress and a crash look the same until
  more bytes land.
* A ``<name>.wal`` that appears is adopted once its REGISTER record is
  readable (``registry.adopt``: the spec verbatim, nothing appended to the
  foreign log).  A tenant whose log ends in an "unloaded" LIFECYCLE record
  is skipped, as recovery skips it.
* The tailer thread waits on an event between polls, so :meth:`stop`
  returns at once.  Promotion is idempotent and final.

Telemetry, as the JAX standby's: each poll counts the records it applied
in ``standby_replayed_records_total`` and sets ``standby_lag_bytes``; a
promotion counts ``standby_promotions_total`` and sets the lag to 0, per
tenant.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from ..obs import metrics as obs_metrics
from . import wal as walmod
from .registry import ServableRegistry, _spec_from_manifest


class WalStandby:
    """Tail a primary's ``wal_dir`` into a warm :class:`ServableRegistry`.

    Args:
        wal_dir: the directory the primary's registry writes
            (``<wal_dir>/<name>.wal`` per tenant).
        registry: the registry to replay into; a fresh one on ``device``
            when None.  It must have no ``wal_dir`` of its own: the
            standby appends nothing until promotion.
        device: the fresh registry's device (default: the card).
        mesh: the fresh registry's serve mesh: a standby on a mesh shards
            its replayed tenants as a primary would (the answers do not
            depend on the mesh).
        poll_interval_s: the tailer thread's wait between polls.
        fsync_every: group-commit interval of the WALs attached at
            promotion (None: ``$REPRO_WAL_FSYNC_EVERY``).
    """

    def __init__(self, wal_dir: str, *,
                 registry: Optional[ServableRegistry] = None, device=None,
                 mesh=None, poll_interval_s: float = 0.05,
                 fsync_every: Optional[int] = None):
        self.wal_dir = wal_dir
        self.registry = (ServableRegistry(device=device, mesh=mesh)
                         if registry is None else registry)
        self.poll_interval_s = float(poll_interval_s)
        self._fsync_every = fsync_every
        self._followers: Dict[str, walmod.WalFollower] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._promoted = False

    # -- tailing ------------------------------------------------------------

    def _wal_paths(self) -> Dict[str, str]:
        if not os.path.isdir(self.wal_dir):
            return {}
        return {n[:-len(".wal")]: os.path.join(self.wal_dir, n)
                for n in sorted(os.listdir(self.wal_dir))
                if n.endswith(".wal")}

    def _adopt_new(self) -> None:
        """Adopt tenants whose WAL appeared since the last poll."""
        for name, path in self._wal_paths().items():
            if name in self._followers:
                continue
            if walmod.read_last_lifecycle(path) == "unloaded":
                continue
            raw = walmod.read_spec(path)
            if raw is None:
                continue              # REGISTER not readable yet: retry
            self.registry.adopt(_spec_from_manifest(raw))
            self._followers[name] = walmod.WalFollower(path)

    def poll_once(self) -> Dict[str, dict]:
        """One tail step: adopt new tenants, replay the records appended
        since the last step.  Returns per tenant ``{"applied",
        "dropped_duplicates", "lag_bytes"}``."""
        with self._lock:
            if self._promoted:
                return {}
            self._adopt_new()
            out: Dict[str, dict] = {}
            reg = obs_metrics.registry()
            for name, fol in self._followers.items():
                records, _ = fol.poll()
                counts = {"applied": 0, "dropped_duplicates": 0}
                if records:
                    counts = self.registry.get(name).index.apply_records(
                        records)
                    reg.inc("standby_replayed_records_total",
                            counts["applied"], tenant=name)
                lag = fol.lag_bytes()
                reg.set("standby_lag_bytes", lag, tenant=name)
                out[name] = dict(counts, lag_bytes=lag)
            return out

    def lag(self) -> Dict[str, int]:
        """Per-tenant bytes not replayed yet (0: caught up with the clean
        prefix)."""
        with self._lock:
            return {n: f.lag_bytes() for n, f in self._followers.items()}

    def start(self) -> None:
        """Run the tailer thread: :meth:`poll_once` every
        ``poll_interval_s``."""
        if self._thread is not None or self._promoted:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.poll_interval_s):
                self.poll_once()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="wal-standby")
        self._thread.start()

    def stop(self) -> None:
        """Stop the tailer thread and join it (at most 5 s: one poll in
        progress).  A thread still alive after that stays
        :attr:`running`."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None

    @property
    def running(self) -> bool:
        """Whether the tailer thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    # -- failover -----------------------------------------------------------

    def promote(self, truncate: bool = True) -> Dict[str, dict]:
        """Become the primary.

        1. stop the tailer and drain every log once more (the primary is
           taken to be dead: a torn tail is now damage);
        2. drop a tenant whose log ends in "unloaded";
        3. ``truncate`` torn tails at the clean prefix's end, so later
           appends replay;
        4. attach a :class:`WriteAheadLog` to each tenant, appending where
           the primary stopped.

        Returns per-tenant reports (records applied by the last poll, the
        final offset, the truncation).  A second call returns ``{}``.
        The drain holds the standby's lock, so a poll still in progress
        after :meth:`stop` finishes first and no record applies twice."""
        self.stop()
        with self._lock:
            if self._promoted:
                return {}
            self._promoted = True
            return self._drain(truncate)

    def _drain(self, truncate: bool) -> Dict[str, dict]:
        self._adopt_new()
        reports: Dict[str, dict] = {}
        for name, fol in list(self._followers.items()):
            if walmod.read_last_lifecycle(fol.path) == "unloaded":
                self.registry._drop(name)
                del self._followers[name]
                reports[name] = {"skipped": "unloaded"}
                continue
            records, report = walmod.read_wal(fol.path, start=fol.offset)
            counts = {"applied": 0, "dropped_duplicates": 0}
            if records:
                counts = self.registry.get(name).index.apply_records(records)
            fol.offset = report["end_offset"]
            rep = dict(report, **counts)
            if report["truncated"] and truncate:
                with open(fol.path, "rb+") as f:
                    f.truncate(report["end_offset"])
                rep["truncated_to"] = report["end_offset"]
            self.registry.get(name).index.attach_wal(
                walmod.WriteAheadLog(fol.path,
                                     fsync_every=self._fsync_every))
            reg = obs_metrics.registry()
            reg.inc("standby_promotions_total", tenant=name)
            reg.set("standby_lag_bytes", 0, tenant=name)
            reports[name] = rep
        return reports
