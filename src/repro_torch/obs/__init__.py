"""Process-wide observability: tracing, metrics, structured export.

The port's own copy of ``repro/obs`` (the port imports nothing of the JAX
package, not even its stdlib-only modules); the catalog, the span names
and the export format are the JAX package's, so one reader
(``tools/check_metrics_export.py``) validates either package's export.

Layering: ``obs`` sits *below* everything else in the port (stdlib-only --
no torch, no numpy), so any layer may import it without cycles:

    obs.metrics   unified registry (counters/gauges/histograms, label
                  sets) with a canonical CATALOG -- the documented schema
    obs.trace     sampled span tracer (trace-id propagation, deterministic
                  sampling, bounded ring buffer) -- the REPRO_TRACE_* knobs
    obs.export    JSON-lines / Prometheus export to file or UDS sink

The one exception to "anyone may import obs" is ``serve/faults.py``, which
stays import-free at module level by design and publishes via a lazy
import inside ``fire()`` (same pattern as the checkpoint layer's fault
hook).

Lock order: the registry's lock, the tracer's lock and the exporter's
lock are leaves -- nothing is acquired while one is held, and no publish
calls back into an index, a WAL or a pool -- so any thread may publish
while it holds the index lock (the WAL appends under it).
"""

from .export import Exporter, render_prometheus
from .metrics import CATALOG, MetricsRegistry, MetricSpec, registry
from .trace import STAGE_SPANS, TraceContext, Tracer, configure, tracer

__all__ = [
    "CATALOG",
    "Exporter",
    "MetricSpec",
    "MetricsRegistry",
    "STAGE_SPANS",
    "TraceContext",
    "Tracer",
    "configure",
    "registry",
    "render_prometheus",
    "tracer",
]
