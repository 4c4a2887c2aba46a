"""Structured out-of-process export: JSON-lines + Prometheus text.

The exporter is the *only* bridge between in-process telemetry and the
outside world: it snapshots the
:class:`~repro_torch.obs.metrics.MetricsRegistry` and drains the
:class:`~repro_torch.obs.trace.Tracer` ring into an append-only
JSON-lines sink (a file, or a ``unix://`` stream socket for an agent
sidecar), one self-describing object per line:

    {"kind": "metric", "ts": ..., "name": ..., "type": "counter",
     "labels": {...}, "value": ...}
    {"kind": "metric", "ts": ..., "name": ..., "type": "histogram",
     "labels": {...}, "buckets": [[le, cumulative], ...], "sum": ...,
     "count": ...}
    {"kind": "span", "ts": ..., "trace_id": ..., "span_id": ...,
     "parent_id": ..., "name": ..., "t0": ..., "t1": ..., "attrs": {...}}

Every flush writes one full metric snapshot stamped with a shared ``ts``,
so a reader reconstructs rates (QPS, fsync/s) from counter deltas between
snapshots and never needs in-process access --
``tools/check_metrics_export.py`` is exactly such a reader and CI runs it
against a live serve export.  A Prometheus text rendering
(:func:`render_prometheus`) is written alongside for scrape-style
consumers.

Flushing is explicit (`flush()`) or periodic (`start(interval_s)`); the
serve launcher flushes once per loop step so export cadence tracks real
work, not wall-clock.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import IO, Optional

from . import metrics as _metrics
from . import trace as _trace


def render_prometheus(reg: Optional[_metrics.MetricsRegistry] = None) -> str:
    """Prometheus exposition-format text for every series in ``reg``."""
    reg = _metrics.registry() if reg is None else reg
    lines = []
    seen_help = set()
    for entry in reg.collect():
        name, typ = entry["name"], entry["type"]
        if name not in seen_help:
            seen_help.add(name)
            spec = reg.catalog[name]
            lines.append(f"# HELP {name} {spec.help}")
            lines.append(f"# TYPE {name} {typ}")

        def _lab(extra=()):
            items = list(entry["labels"].items()) + list(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + body + "}"

        if typ == "histogram":
            for le, cum in entry["buckets"]:
                lines.append(f"{name}_bucket{_lab([('le', le)])} {cum}")
            lines.append(f"{name}_sum{_lab()} {entry['sum']}")
            lines.append(f"{name}_count{_lab()} {entry['count']}")
        else:
            lines.append(f"{name}{_lab()} {entry['value']}")
    return "\n".join(lines) + "\n"


class _UdsSink:
    """Line sink over a unix stream socket (``unix:///path/to.sock``)."""

    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)

    def write(self, data: str) -> None:
        self.sock.sendall(data.encode("utf-8"))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.sock.close()


class Exporter:
    """Periodic/explicit JSONL exporter for one (registry, tracer) pair."""

    def __init__(self, sink: str,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer: Optional[_trace.Tracer] = None,
                 prom_path: Optional[str] = None,
                 clock=time.time):
        self.registry = _metrics.registry() if registry is None else registry
        self.tracer = _trace.tracer() if tracer is None else tracer
        self.prom_path = prom_path
        self.clock = clock
        self.n_flushes = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if sink.startswith("unix://"):
            self._sink: object = _UdsSink(sink[len("unix://"):])
        else:
            os.makedirs(os.path.dirname(os.path.abspath(sink)),
                        exist_ok=True)
            self._sink = open(sink, "a", encoding="utf-8")

    @classmethod
    def for_directory(cls, metrics_dir: str, **kw) -> "Exporter":
        """The ``--metrics-dir`` layout: ``metrics.jsonl`` (append) plus a
        ``metrics.prom`` rendering rewritten on every flush."""
        os.makedirs(metrics_dir, exist_ok=True)
        return cls(os.path.join(metrics_dir, "metrics.jsonl"),
                   prom_path=os.path.join(metrics_dir, "metrics.prom"),
                   **kw)

    def flush(self) -> int:
        """Write one metric snapshot + drain pending spans; returns the
        number of lines written."""
        with self._lock:
            ts = self.clock()
            lines = []
            for entry in self.registry.collect():
                lines.append(json.dumps(
                    {"kind": "metric", "ts": ts, **entry},
                    sort_keys=True, default=str))
            for span in self.tracer.drain():
                lines.append(json.dumps(
                    {"kind": "span", "ts": ts, **span},
                    sort_keys=True, default=str))
            if lines:
                self._sink.write("\n".join(lines) + "\n")
                self._sink.flush()
            if self.prom_path is not None:
                tmp = self.prom_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(render_prometheus(self.registry))
                os.replace(tmp, self.prom_path)
            self.n_flushes += 1
            return len(lines)

    # -- periodic mode ---------------------------------------------------

    def start(self, interval_s: float) -> None:
        """Flush every ``interval_s`` seconds on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("exporter already started")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                self.flush()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="obs-exporter")
        self._thread.start()

    def close(self) -> None:
        """Stop the periodic thread (if any), final flush, release sink."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush()
        self._sink.close()
