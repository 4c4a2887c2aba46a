"""Unified metrics registry: counters, gauges, histograms with label sets.

The port's copy of ``repro/obs/metrics.py``: the same :data:`CATALOG`
(every name, type, label tuple, ``required`` flag and bucket list, the
entries the port does not emit yet included, so the schema is one) and
the same registry, plus :meth:`MetricsRegistry.inc_each`, which publishes
one counter's series for many label values under one lock (the segment
wins of a batch over a few hundred sealed segments).

Every telemetry signal in the serve stack publishes into one process-wide
:class:`MetricsRegistry` instead of ad-hoc per-module dicts: `ServingStats`
(query/insert/batch counters, latency histograms, fan-out win counts), the
write path (`serve/wal.py` append/fsync, `checkpoint/` save/restore), the
maintenance pool, the warm standby, and `serve/faults.py` trigger counts.  The
registry is the *source of truth the exporter reads* -- `obs/export.py`
serialises :meth:`MetricsRegistry.collect` to JSON-lines / Prometheus text
so the process can be observed without any in-process access.

Schema is code: :data:`CATALOG` declares every metric the system may emit
(name, type, label names, help, whether the standard telemetry smoke must
see it).  The registry rejects names or label sets not in the catalog, so
"no undocumented metric names" is enforced at the publish site, and
``tools/check_metrics_export.py`` validates exported lines against the
same catalog -- drift between docs, code, and export is structurally
impossible.

Publishing is cheap (one lock, one dict update) and allocation-light so it
can sit on the query hot path unconditionally; *tracing* is the sampled
layer (see `obs/trace.py`), metrics are always on.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

# Default histogram bucket upper bounds (seconds) -- log-ish spacing from
# 10us to 10s; +Inf is implicit.  Latency-shaped by design: every histogram
# in the catalog measures a duration.
DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One catalog entry: the contract for a single metric name."""

    name: str
    type: str                      # "counter" | "gauge" | "histogram"
    help: str
    labels: Tuple[str, ...] = ()
    required: bool = False         # must appear in the standard telemetry
    #                                smoke export (serve run with WAL +
    #                                snapshot + shard + recall + deep trace)
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        if self.type not in ("counter", "gauge", "histogram"):
            raise ValueError(f"bad metric type {self.type!r}")


def _catalog(*specs: MetricSpec) -> Dict[str, MetricSpec]:
    out: Dict[str, MetricSpec] = {}
    for s in specs:
        if s.name in out:
            raise ValueError(f"duplicate metric {s.name!r}")
        out[s.name] = s
    return out


#: The documented metric schema.  ``required=True`` entries form the
#: contract of the CI telemetry smoke: a standard serve run (WAL on,
#: snapshot at exit, sharded mesh, periodic recall probe, deep tracing)
#: must export every one of them.  Everything else is situational (faults
#: only fire under an installed plan, restores only happen on recovery,
#: router load only exists when replication routes).
CATALOG: Dict[str, MetricSpec] = _catalog(
    # -- query path ------------------------------------------------------
    MetricSpec("serve_queries_total", "counter",
               "Query rows admitted per tenant", ("tenant",), required=True),
    MetricSpec("serve_inserts_total", "counter",
               "Items inserted per tenant", ("tenant",), required=True),
    MetricSpec("serve_deletes_total", "counter",
               "Items tombstoned per tenant", ("tenant",), required=True),
    MetricSpec("serve_rejected_inserts_total", "counter",
               "Inserts rejected (capacity) per tenant", ("tenant",)),
    MetricSpec("serve_batches_total", "counter",
               "Micro-batches dispatched per tenant", ("tenant",),
               required=True),
    MetricSpec("serve_batch_rows_real_total", "counter",
               "Real query rows inside dispatched batches", ("tenant",),
               required=True),
    MetricSpec("serve_batch_rows_padded_total", "counter",
               "Padded rows (palette fill) inside dispatched batches",
               ("tenant",), required=True),
    MetricSpec("serve_query_latency_s", "histogram",
               "End-to-end batch query latency", ("tenant",), required=True),
    MetricSpec("serve_queue_wait_s", "histogram",
               "Admission-to-dispatch wait per request", ("tenant",),
               required=True),
    MetricSpec("serve_stage_latency_s", "histogram",
               "Per-stage query/write latency from trace spans",
               ("tenant", "stage"), required=True),
    MetricSpec("serve_segment_wins_total", "counter",
               "Merged top-k slots won per segment", ("tenant", "segment"),
               required=True),
    MetricSpec("serve_device_wins_total", "counter",
               "Merged top-k slots won per device (sharded serve)",
               ("tenant", "device"), required=True),
    MetricSpec("serve_device_load_total", "counter",
               "Routed segment-instance load per device (replicated serve)",
               ("tenant", "device")),
    MetricSpec("serve_recall_proxy", "gauge",
               "Latest periodic sampled recall-vs-brute-force probe",
               ("tenant",), required=True),
    MetricSpec("router_device_load", "gauge",
               "QueryRouter cumulative load ledger per device",
               ("tenant", "device")),
    # Situational: only published once a tenant has sealed segments
    # (store_bytes) or serves a quantized precision tier (survivor_frac).
    MetricSpec("store_bytes_per_item", "gauge",
               "Sealed-segment storage bytes per live item (precision tier)",
               ("tenant",)),
    MetricSpec("rerank_survivor_frac", "gauge",
               "Fraction of survivor-rerank slots holding real candidates",
               ("tenant",)),
    # -- write path ------------------------------------------------------
    MetricSpec("wal_appends_total", "counter",
               "WAL records appended", ("tenant",), required=True),
    MetricSpec("wal_bytes_total", "counter",
               "WAL bytes appended (frame headers included)", ("tenant",),
               required=True),
    MetricSpec("wal_fsyncs_total", "counter",
               "WAL fsync barriers issued", ("tenant",), required=True),
    MetricSpec("wal_append_latency_s", "histogram",
               "WAL append (buffered write + flush) latency", ("tenant",),
               required=True),
    MetricSpec("wal_fsync_latency_s", "histogram",
               "WAL fsync barrier latency", ("tenant",), required=True),
    MetricSpec("ckpt_saves_total", "counter",
               "Checkpoints written", ("tenant",), required=True),
    MetricSpec("ckpt_save_latency_s", "histogram",
               "Checkpoint write+rename latency", ("tenant",),
               required=True),
    MetricSpec("ckpt_restores_total", "counter",
               "Checkpoints restored", ("tenant",)),
    MetricSpec("ckpt_restore_latency_s", "histogram",
               "Checkpoint restore latency", ("tenant",)),
    MetricSpec("ckpt_corrupt_total", "counter",
               "Checkpoint steps that failed verification", ("tenant",)),
    MetricSpec("recovery_replayed_records_total", "counter",
               "WAL records replayed during recovery", ("tenant",)),
    MetricSpec("recovery_restores_total", "counter",
               "Tenant states restored from checkpoint during recovery",
               ("tenant",)),
    MetricSpec("faults_fired_total", "counter",
               "Injected faults triggered (raise-action only)", ("site",)),
    # -- serving front-end (serve/frontend.py) ---------------------------
    # Situational (required=False): these series only exist when a network
    # front-end is live; the standard telemetry smoke is library-driven.
    MetricSpec("frontend_requests_total", "counter",
               "Wire requests received per tenant and op",
               ("tenant", "op")),
    MetricSpec("frontend_rejects_total", "counter",
               "Admission rejections (explicit backpressure) per tenant "
               "and reason", ("tenant", "reason")),
    MetricSpec("frontend_inflight", "gauge",
               "Admitted-but-unanswered requests per tenant",
               ("tenant",)),
    MetricSpec("frontend_queue_depth", "gauge",
               "Tenant batcher queue depth sampled at admission",
               ("tenant",)),
    MetricSpec("frontend_request_latency_s", "histogram",
               "Admission-to-response wire request latency", ("tenant",)),
    MetricSpec("frontend_deadline_expired_total", "counter",
               "Admitted requests whose deadline passed before the answer",
               ("tenant",)),
    MetricSpec("frontend_drained_requests_total", "counter",
               "Accepted requests answered while draining toward "
               "unload/shutdown", ("tenant",)),
    MetricSpec("frontend_connections_total", "counter",
               "Client connections accepted"),
    MetricSpec("tenant_lifecycle_transitions_total", "counter",
               "Servable lifecycle transitions (loading/ready/draining/"
               "unloaded/updated)", ("tenant", "state")),
    # -- in-place maintenance (serve/maintenance.py, sharding/placement.py)
    # Situational: these series only exist once a placement rebuild or a
    # maintenance job has actually run.
    MetricSpec("placement_replaced_bytes_total", "counter",
               "Bytes actually transferred by placement rebuilds "
               "(incremental diffs move only changed slots)", ("tenant",)),
    MetricSpec("placement_restack_bytes_total", "counter",
               "Bytes a full restack would have transferred per placement "
               "rebuild (the denominator of the re-placement win)",
               ("tenant",)),
    MetricSpec("placement_rebuilds_total", "counter",
               "Placement rebuilds by kind (diff vs full restack)",
               ("tenant", "kind")),
    MetricSpec("maintenance_jobs_total", "counter",
               "Background maintenance jobs by kind and terminal status",
               ("tenant", "kind", "status")),
    MetricSpec("maintenance_job_latency_s", "histogram",
               "Maintenance job run time (dequeue to completion)",
               ("tenant", "kind")),
    MetricSpec("maintenance_queue_depth", "gauge",
               "Maintenance jobs queued or running"),
    # -- warm standby (serve/standby.py) ---------------------------------
    MetricSpec("standby_replayed_records_total", "counter",
               "WAL records the standby replayed while tailing",
               ("tenant",)),
    MetricSpec("standby_lag_bytes", "gauge",
               "Primary-WAL bytes the standby has not replayed yet",
               ("tenant",)),
    MetricSpec("standby_promotions_total", "counter",
               "Standby tenants promoted to primary", ("tenant",)),
)


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, le in enumerate(self.buckets):            # noqa: B007
            if value <= le:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def as_dict(self) -> dict:
        # cumulative counts per le, Prometheus-style
        cum, out = 0, []
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append([le, cum])
        out.append(["+Inf", self.count])
        return {"buckets": out, "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Thread-safe registry of catalog-declared metrics.

    Instruments are created lazily on first publish; a publish with a name
    or label set the catalog doesn't declare raises -- add the metric to
    :data:`CATALOG` first (that *is* the documentation the export checker
    enforces).
    """

    def __init__(self, catalog: Optional[Dict[str, MetricSpec]] = None):
        self.catalog = CATALOG if catalog is None else catalog
        self._lock = threading.Lock()
        # name -> {label_values_tuple: float | _Histogram}
        self._data: Dict[str, Dict[Tuple[str, ...], object]] = {}
        # bumped on reset(); observe_handle callers key their caches on it
        self.generation = 0
        # inc_each's label tuples: (name, labels before, after) -> {value:
        # full label tuple}
        self._keys: Dict[tuple, dict] = {}

    def _series(self, name: str, kind: str, labels: dict):
        spec = self.catalog.get(name)
        if spec is None:
            raise KeyError(
                f"metric {name!r} is not in obs.metrics.CATALOG -- declare "
                f"it there (that is the documented schema) before publishing")
        if spec.type != kind:
            raise TypeError(f"metric {name!r} is a {spec.type}, not a {kind}")
        if tuple(sorted(labels)) != tuple(sorted(spec.labels)):
            raise ValueError(
                f"metric {name!r} wants labels {spec.labels}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[k]) for k in spec.labels)
        series = self._data.setdefault(name, {})
        if key not in series:
            series[key] = _Histogram(spec.buckets) if kind == "histogram" \
                else 0.0
        return spec, series, key

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            _, series, key = self._series(name, "counter", labels)
            series[key] += value

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            _, series, key = self._series(name, "gauge", labels)
            series[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            _, series, key = self._series(name, "histogram", labels)
            series[key].observe(float(value))

    def inc_each(self, name: str, label: str, values, **labels) -> None:
        """``inc(name, v, **labels, **{label: key})`` for every ``(key, v)``
        pair of ``values``, validated once and under one lock."""
        spec = self.catalog.get(name)
        if spec is None or spec.type != "counter" or tuple(
                sorted((*labels, label))) != tuple(sorted(spec.labels)):
            raise ValueError(f"metric {name!r} is not a counter with "
                             f"labels {spec.labels if spec else ()}")
        at = spec.labels.index(label)
        key = [str(labels.get(k, "")) for k in spec.labels]
        head, tail = tuple(key[:at]), tuple(key[at + 1:])
        with self._lock:
            series = self._data.setdefault(name, {})
            get = series.get
            # the label tuples of this (name, other labels), built once
            keys = self._keys.setdefault((name, head, tail), {})
            for value, v in values:
                t = keys.get(value)
                if t is None:
                    t = keys[value] = head + (str(value),) + tail
                series[t] = get(t, 0.0) + v

    def observe_handle(self, name: str, **labels):
        """Pre-validated observe callable for one histogram series.

        Catalog/label validation and series lookup happen once, here,
        instead of on every publish -- for hot-path callers (the tracer
        observes a stage histogram per finished span).  A handle goes
        stale when :meth:`reset` drops the series it is bound to: cache
        it keyed on :attr:`generation` and re-acquire on mismatch.
        """
        with self._lock:
            _, series, key = self._series(name, "histogram", labels)
            hist = series[key]
        lock = self._lock

        def observe(value: float) -> None:
            with lock:
                hist.observe(float(value))

        return observe

    # -- reading ---------------------------------------------------------

    def value(self, name: str, **labels):
        """Current value of one series (float, or histogram dict)."""
        spec = self.catalog[name]
        key = tuple(str(labels[k]) for k in spec.labels)
        with self._lock:
            v = self._data.get(name, {}).get(key)
            if isinstance(v, _Histogram):
                return v.as_dict()
            return v

    def collect(self) -> List[dict]:
        """Snapshot every series as a flat list of export-ready dicts."""
        out: List[dict] = []
        with self._lock:
            for name in sorted(self._data):
                spec = self.catalog[name]
                for key in sorted(self._data[name]):
                    v = self._data[name][key]
                    entry = {
                        "name": name,
                        "type": spec.type,
                        "labels": dict(zip(spec.labels, key)),
                    }
                    if isinstance(v, _Histogram):
                        entry.update(v.as_dict())
                    else:
                        entry["value"] = v
                    out.append(entry)
        return out

    def summary(self, **labels) -> Dict[str, object]:
        """Compact ``{name{labels}: value}`` view of every series whose
        labels are a superset of ``labels`` (counters/gauges as floats,
        histograms as ``count/sum``) -- used by ``ServableRegistry.report``
        to fold per-tenant telemetry into the report dict."""
        want = {k: str(v) for k, v in labels.items()}
        out: Dict[str, object] = {}
        for entry in self.collect():
            if any(entry["labels"].get(k) != v for k, v in want.items()):
                continue
            extra = {k: v for k, v in entry["labels"].items()
                     if k not in want}
            tag = "" if not extra else \
                "{" + ",".join(f"{k}={v}" for k, v in sorted(
                    extra.items())) + "}"
            if entry["type"] == "histogram":
                out[entry["name"] + tag] = {
                    "count": entry["count"],
                    "sum": round(entry["sum"], 6),
                }
            else:
                out[entry["name"] + tag] = entry["value"]
        return out

    def reset(self) -> None:
        with self._lock:
            self._data.clear()
            self.generation += 1


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every publish site uses."""
    return _default
