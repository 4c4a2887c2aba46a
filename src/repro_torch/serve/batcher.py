"""Deadline-driven micro-batcher over a fixed chunk-shape palette.

The port's own copy of ``repro/serve/batcher.py``.  Requests with one
(k, n_probes) signature share a row buffer; a signature flushes when a
full largest chunk is queued or its oldest request's deadline
(``max_delay_ms``) passes, and every flush is padded up to a palette size,
so the index only ever sees ``len(chunk_sizes)`` query shapes per
signature.  ``submit`` returns a Future; ``pump`` decides flushes;
``flush_all`` drains everything.

Two clock modes share the one code path:

* **injected clock** (tests, the demo loop): construct with ``clock=sim``
  and call ``pump(now)`` by hand, with no thread;
* **wall clock** (the network front-end): ``start()`` runs a pump thread
  that sleeps until the earliest pending deadline (a condition wait that
  ``submit`` wakes early) and then calls the same ``pump``, so the thread
  changes when batches run, never what they hold.  ``stop()`` joins it
  and flushes what is left.  The pump thread launches the index's
  kernels; ``dispatch.resolve_device`` pins the index's card for it.

Telemetry, as the JAX batcher's: a request's trace starts at admission
(the submitter's context, or a new one at the sample rate: None when
sampling is off), its queue wait feeds ``serve_queue_wait_s`` and, when
sampled, a retroactive ``admission`` span; each padded chunk runs under
a ``batch`` span attached to the first sampled request's context, so the
index's stage spans land in a real trace.  ``on_answer`` sees each
chunk's host ids (its padding rows included) after the batch span and
the latency (``on_batch``): the serve layer's segment-win attribution.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

# fn(queries_padded (c, N), k, n_probes) -> (ids (c, k), dists (c, k)), numpy
QueryFn = Callable[[np.ndarray, int, int], Tuple[np.ndarray, np.ndarray]]


@dataclass
class _Pending:
    queries: np.ndarray
    k: int
    n_probes: int
    deadline: float
    submitted: float = 0.0
    ctx: Optional[obs_trace.TraceContext] = None   # admission trace
    future: Future = field(default_factory=Future)


class MicroBatcher:
    """Coalesces query requests into palette-sized padded chunks."""

    def __init__(self, query_fn: QueryFn, *,
                 chunk_sizes: Sequence[int] = (8, 32, 128),
                 max_delay_ms: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_batch: Optional[Callable[[int, int, float], None]] = None,
                 on_answer: Optional[Callable[[np.ndarray], None]] = None,
                 tenant: str = "default",
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        if not chunk_sizes or sorted(chunk_sizes) != list(chunk_sizes):
            raise ValueError("chunk_sizes must be ascending and non-empty")
        self.query_fn = query_fn
        self.chunk_sizes = tuple(int(c) for c in chunk_sizes)
        self.max_delay = max_delay_ms / 1e3
        self.clock = clock
        self.on_batch = on_batch            # (rows_real, rows_padded, dt)
        self.on_answer = on_answer          # (ids of the padded chunk,)
        self.tenant = tenant
        self.metrics = obs_metrics.registry() if metrics is None else metrics
        self.shape_counts: Counter = Counter()   # (chunk, k, n_probes) -> n
        self.n_requests = 0
        self.n_batches = 0
        self._q: Dict[Tuple[int, int], List[_Pending]] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def submit(self, queries, k: int, n_probes: int = 1) -> Future:
        """Enqueue a (nq, N) request; resolves to (ids (nq, k), dists)."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2:
            raise ValueError(f"expected (nq, N) queries, got {q.shape}")
        now = self.clock()
        tr = obs_trace.tracer()
        ctx = tr.current()
        if ctx is None:
            ctx = tr.start_trace()
        req = _Pending(queries=q, k=int(k), n_probes=int(n_probes),
                       deadline=now + self.max_delay, submitted=now,
                       ctx=ctx)
        with self._wake:
            self._q.setdefault((req.k, req.n_probes), []).append(req)
            self.n_requests += 1
            self._wake.notify()
        return req.future

    def query(self, queries, k: int, n_probes: int = 1):
        """Synchronous convenience: submit + flush everything + wait."""
        fut = self.submit(queries, k, n_probes)
        self.flush_all()
        return fut.result()

    def _chunk_for(self, rows: int) -> int:
        for c in self.chunk_sizes:
            if rows <= c:
                return c
        return self.chunk_sizes[-1]

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Flush every signature whose deadline passed or whose buffer
        filled the largest chunk.  Returns the number of batches run."""
        now = self.clock() if now is None else now
        max_chunk = self.chunk_sizes[-1]
        todo: List[Tuple[Tuple[int, int], List[_Pending]]] = []
        with self._lock:
            for key, reqs in self._q.items():
                if not reqs:
                    continue
                rows = sum(r.queries.shape[0] for r in reqs)
                if force or rows >= max_chunk or reqs[0].deadline <= now:
                    todo.append((key, reqs))
                    self._q[key] = []
        return sum(self._dispatch(key, reqs) for key, reqs in todo)

    def flush_all(self) -> int:
        return self.pump(force=True)

    def _dispatch(self, key: Tuple[int, int], reqs: List[_Pending]) -> int:
        """Pack the requests' rows into palette chunks, run, scatter back.
        A failure is routed to every stranded Future: a batch may die, the
        batcher does not."""
        k, n_probes = key
        batches = 0
        tr = obs_trace.tracer()
        t_disp = self.clock()
        # the admission span's times re-based onto the tracer's clock
        t_tr = tr.clock()
        for r in reqs:
            wait = max(t_disp - r.submitted, 0.0)
            self.metrics.observe("serve_queue_wait_s", wait,
                                 tenant=self.tenant)
            if r.ctx is not None and r.ctx.sampled:
                tr.record("admission", t_tr - wait, t_tr, ctx=r.ctx,
                          tenant=self.tenant, rows=int(r.queries.shape[0]))
        ctx = next((r.ctx for r in reqs
                    if r.ctx is not None and r.ctx.sampled), None)
        try:
            rows = np.concatenate([r.queries for r in reqs])
            total, n_dims = rows.shape
            max_chunk = self.chunk_sizes[-1]
            outs_i, outs_d = [], []
            pos = 0
            while pos < total:
                take = min(max_chunk, total - pos)
                chunk = self._chunk_for(take)
                buf = np.zeros((chunk, n_dims), np.float32)
                buf[:take] = rows[pos:pos + take]
                t0 = self.clock()
                if ctx is not None:
                    with tr.attach(ctx), tr.span(
                            "batch", tenant=self.tenant, rows_real=take,
                            rows_padded=chunk, k=k, n_probes=n_probes):
                        ids, dists = self.query_fn(buf, k, n_probes)
                else:
                    ids, dists = self.query_fn(buf, k, n_probes)
                self.shape_counts[(chunk, k, n_probes)] += 1
                self.n_batches += 1
                batches += 1
                if self.on_batch is not None:
                    self.on_batch(take, chunk, self.clock() - t0)
                ids = np.asarray(ids)
                if self.on_answer is not None:
                    self.on_answer(ids)
                outs_i.append(ids[:take])
                outs_d.append(np.asarray(dists)[:take])
                pos += take
            all_i = np.concatenate(outs_i)
            all_d = np.concatenate(outs_d)
        except Exception as e:  # noqa: BLE001 -- routed to the futures
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return batches
        pos = 0
        for r in reqs:
            m = r.queries.shape[0]
            r.future.set_result((all_i[pos:pos + m], all_d[pos:pos + m]))
            pos += m
        return batches

    # -- wall-clock pump ----------------------------------------------------

    def start(self) -> "MicroBatcher":
        """Start the pump thread (no-op while one runs)."""
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"pump-{self.tenant}")
        self._thread.start()
        return self

    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Stop and join the pump thread, then flush what is queued."""
        with self._wake:
            self._stop = True
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                raise TimeoutError(f"pump thread of {self.tenant!r} still "
                                   f"running after {timeout_s}s")
            self._thread = None
        self.flush_all()

    def _wait_s(self) -> Optional[float]:
        """Seconds until the earliest flush (callers hold the lock): None
        when the queue is empty (park until a submit), 0.0 to flush now (a
        signature filled the largest chunk or its oldest deadline
        passed)."""
        max_chunk = self.chunk_sizes[-1]
        now = self.clock()
        best: Optional[float] = None
        for reqs in self._q.values():
            if not reqs:
                continue
            if sum(r.queries.shape[0] for r in reqs) >= max_chunk:
                return 0.0
            dt = reqs[0].deadline - now
            best = dt if best is None else min(best, dt)
        return None if best is None else max(best, 0.0)

    def _loop(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    return
                wait = self._wait_s()
                if wait is None:
                    self._wake.wait(timeout=0.05)
                elif wait > 0.0:
                    self._wake.wait(timeout=wait)
                if self._stop:
                    return
            try:
                self.pump()
            except Exception:  # noqa: BLE001 -- _dispatch routed the
                # error to the batch's futures; the thread serves the rest
                pass

    def unique_shapes(self) -> int:
        """Distinct padded (chunk, k, n_probes) shapes dispatched so far."""
        return len(self.shape_counts)

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._q.values())
