"""Allocation-light span tracing for the query and write paths.

The port's copy of ``repro/obs/trace.py``: the same spans, sampling,
ring and knobs.  The staged engine's per-stage device sync is the port's
own (``SegmentedIndex.query``: ``torch.cuda.synchronize`` at each stage
span's end, on the card and on the staged path only).

One :class:`Tracer` per process (module singleton, :func:`tracer`), driven
by the ``REPRO_TRACE_*`` knob family:

==========================  =================================================
``REPRO_TRACE_SAMPLE``      trace sampling rate in [0, 1] (default 0: off)
``REPRO_TRACE_BUFFER``      span ring-buffer capacity (default 4096)
``REPRO_TRACE_DEEP``        1 -> sampled fp32 queries run the *staged*
                            engine (the stacked query's hash, probe,
                            gather, rerank and merge, each under its own
                            span ended by a device sync); default 0 ->
                            coarse spans around host-call boundaries only
==========================  =================================================

Semantics:

- A trace begins where a request is admitted (``MicroBatcher.submit``) or
  wherever the first ``span()`` runs with no ambient context (write-path
  events like a WAL fsync or a seal trace themselves).  The sampling
  decision is **deterministic in the trace id** (splitmix64 hash compared
  against the rate), so a trace is sampled-or-not as a unit and replaying
  the same id sequence samples the same traces.
- ``span("stage", **attrs)`` is a context manager; spans nest via a
  per-thread context stack, giving parent ids without any global state.
  ``record(name, t0, t1)`` writes a span retroactively (used for
  queue-wait, whose start happened on the submitting thread).
- ``attach(ctx)`` moves a context across threads -- the batcher captures
  the submitter's context and attaches it on the dispatch thread.
- Completed spans land in a bounded ring buffer (old spans drop first);
  the exporter drains it.  Stage-taxonomy spans also observe the
  ``serve_stage_latency_s`` histogram so stage timings survive in metrics
  after the ring has rotated.

Cost contract (invariant 8 of the JAX package): with sampling off every
hook is a no-op behind one attribute load and the query path launches the
identical kernels -- results are bit-identical to an untraced process.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import metrics as _metrics

_ENV_SAMPLE = "REPRO_TRACE_SAMPLE"
_ENV_BUFFER = "REPRO_TRACE_BUFFER"
_ENV_DEEP = "REPRO_TRACE_DEEP"

#: Span names that feed the ``serve_stage_latency_s{tenant,stage}``
#: histogram (the stage taxonomy -- see docs/architecture.md).
STAGE_SPANS = frozenset({
    "request", "admission", "embed", "batch",
    "hash", "probe", "gather", "rerank", "merge", "fanin",
    "query.segments", "query.collective",
    "wal.append", "wal.fsync", "seal", "compact",
    "ckpt.save", "ckpt.restore", "recover.restore", "recover.replay",
    "tenant.load", "tenant.unload", "tenant.update",
})


def _mix64(x: int) -> int:
    """splitmix64 finalizer: maps the raw trace counter to a well-mixed
    64-bit value so `hash < rate` sampling is unbiased."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class TraceContext:
    """Identity + sampling decision + span stack of one trace."""

    __slots__ = ("trace_id", "sampled", "stack")

    def __init__(self, trace_id: str, sampled: bool):
        self.trace_id = trace_id
        self.sampled = sampled
        self.stack: List[int] = []


class _Noop:
    """Shared do-nothing span: the entire cost of tracing-off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _Noop()


class Span:
    __slots__ = ("tracer", "ctx", "name", "attrs", "span_id", "parent_id",
                 "t0", "t1", "owns_ctx")

    def __init__(self, tracer: "Tracer", ctx: TraceContext, name: str,
                 attrs: dict, owns_ctx: bool):
        self.tracer = tracer
        self.ctx = ctx
        self.name = name
        self.attrs = attrs
        self.owns_ctx = owns_ctx
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.t0 = 0.0
        self.t1 = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self.owns_ctx:
            self.tracer._tl.ctx = self.ctx
        self.parent_id = self.ctx.stack[-1] if self.ctx.stack else None
        self.ctx.stack.append(self.span_id)
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, *exc):
        self.t1 = self.tracer.clock()
        if self.ctx.stack and self.ctx.stack[-1] == self.span_id:
            self.ctx.stack.pop()
        if self.owns_ctx:
            self.tracer._tl.ctx = None
        self.tracer._finish(self)
        return False


class _CtxGuard:
    """Installs an *unsampled* context for the duration of a would-be root
    span, so descendants inherit the negative sampling decision instead of
    rolling their own traces."""

    __slots__ = ("tracer", "ctx")

    def __init__(self, tracer: "Tracer", ctx: TraceContext):
        self.tracer = tracer
        self.ctx = ctx

    def __enter__(self):
        self.tracer._tl.ctx = self.ctx
        return _NOOP

    def __exit__(self, *exc):
        self.tracer._tl.ctx = None
        return False


class _Attach:
    __slots__ = ("tracer", "ctx", "prev")

    def __init__(self, tracer: "Tracer", ctx: Optional[TraceContext]):
        self.tracer = tracer
        self.ctx = ctx
        self.prev: Optional[TraceContext] = None

    def __enter__(self):
        self.prev = getattr(self.tracer._tl, "ctx", None)
        self.tracer._tl.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        self.tracer._tl.ctx = self.prev
        return False


class Tracer:
    """Process tracer: sampling, context propagation, span ring buffer."""

    def __init__(self, sample_rate: Optional[float] = None,
                 buffer: Optional[int] = None,
                 deep: Optional[bool] = None,
                 clock=time.perf_counter,
                 metrics: Optional[_metrics.MetricsRegistry] = None,
                 seed: int = 0):
        if sample_rate is None:
            sample_rate = float(os.environ.get(_ENV_SAMPLE, "0") or 0)
        if buffer is None:
            buffer = int(os.environ.get(_ENV_BUFFER, "4096") or 4096)
        if deep is None:
            deep = os.environ.get(_ENV_DEEP, "0").lower() in ("1", "true")
        self.sample_rate = float(sample_rate)
        self.deep = bool(deep)
        self.clock = clock
        self.metrics = _metrics.registry() if metrics is None else metrics
        self._seed = seed
        self._ids = itertools.count(1)
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(buffer)))
        self.n_traces = 0
        self.n_spans = 0
        # (tenant, stage) -> (registry generation, pre-validated observe)
        # -- _finish runs per span on the query hot path; re-validating
        # the stage histogram's labels every time costs more than the
        # span itself, so the handle is cached until registry.reset()
        self._stage_obs: dict = {}

    # -- trace lifecycle -------------------------------------------------

    def start_trace(self) -> Optional[TraceContext]:
        """Mint a new trace context (None when sampling is fully off).
        The sampling decision is a pure function of the trace id."""
        if self.sample_rate <= 0.0:
            return None
        raw = _mix64(self._seed ^ next(self._ids))
        sampled = self.sample_rate >= 1.0 or \
            (raw >> 11) / float(1 << 53) < self.sample_rate
        with self._lock:
            self.n_traces += 1
        return TraceContext(f"{raw:016x}", sampled)

    def current(self) -> Optional[TraceContext]:
        return getattr(self._tl, "ctx", None)

    def attach(self, ctx: Optional[TraceContext]) -> _Attach:
        """Context manager: make ``ctx`` current on this thread (restores
        the previous context on exit).  ``attach(None)`` clears."""
        return _Attach(self, ctx)

    def sampled(self) -> bool:
        """Is the current thread inside a sampled trace?"""
        ctx = getattr(self._tl, "ctx", None)
        return ctx is not None and ctx.sampled

    # -- spans -----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a span.  No ambient context -> auto-start a trace whose
        root this span is (write-path events trace themselves)."""
        ctx = getattr(self._tl, "ctx", None)
        if ctx is None:
            ctx = self.start_trace()
            if ctx is None:
                return _NOOP
            if not ctx.sampled:
                return _CtxGuard(self, ctx)
            return Span(self, ctx, name, attrs, owns_ctx=True)
        if not ctx.sampled:
            return _NOOP
        return Span(self, ctx, name, attrs, owns_ctx=False)

    def record(self, name: str, t0: float, t1: float,
               ctx: Optional[TraceContext] = None, **attrs) -> None:
        """Write a completed span retroactively (e.g. queue-wait measured
        between a submit timestamp and dispatch)."""
        if ctx is None:
            ctx = getattr(self._tl, "ctx", None)
        if ctx is None or not ctx.sampled:
            return
        s = Span(self, ctx, name, attrs, owns_ctx=False)
        s.parent_id = ctx.stack[-1] if ctx.stack else None
        s.t0, s.t1 = t0, t1
        self._finish(s)

    def _finish(self, span: Span) -> None:
        entry = {
            "trace_id": span.ctx.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "t0": span.t0,
            "t1": span.t1,
            "attrs": span.attrs,
        }
        with self._lock:
            self._ring.append(entry)
            self.n_spans += 1
        if span.name in STAGE_SPANS:
            tenant = str(span.attrs.get("tenant", "default"))
            cached = self._stage_obs.get((tenant, span.name))
            if cached is None or cached[0] != self.metrics.generation:
                cached = (self.metrics.generation,
                          self.metrics.observe_handle(
                              "serve_stage_latency_s",
                              tenant=tenant, stage=span.name))
                self._stage_obs[tenant, span.name] = cached
            cached[1](span.t1 - span.t0)

    # -- reading ---------------------------------------------------------

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def drain(self) -> List[dict]:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "deep": self.deep,
                "traces_started": self.n_traces,
                "spans_recorded": self.n_spans,
                "spans_buffered": len(self._ring),
            }


_tracer = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer every instrumentation site uses."""
    return _tracer


def configure(sample_rate: Optional[float] = None,
              buffer: Optional[int] = None,
              deep: Optional[bool] = None,
              clock=None, seed: Optional[int] = None) -> Tracer:
    """Reconfigure the process tracer in place (None keeps the current
    value).  Used by ``launch/serve --trace-sample/--trace-deep``, the chip
    smoke and tests (which undo it in a ``finally``); the ring buffer is
    replaced, not drained."""
    t = _tracer
    if sample_rate is not None:
        t.sample_rate = float(sample_rate)
    if deep is not None:
        t.deep = bool(deep)
    if clock is not None:
        t.clock = clock
    if seed is not None:
        t._seed = seed
    if buffer is not None:
        with t._lock:
            t._ring = deque(t._ring, maxlen=max(1, int(buffer)))
    return t
