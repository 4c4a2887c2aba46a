"""Network front-end: an asyncio server over the ``ServableRegistry``.

The port of ``repro/serve/frontend.py``: an asyncio TCP server speaking
:mod:`repro_torch.serve.protocol` (newline-delimited JSON, the JAX
package's frames byte for byte) that multiplexes concurrent client
connections into the per-tenant
:class:`~repro_torch.serve.batcher.MicroBatcher` queues under wall-clock
deadlines: one server process, many named servables, admission control
at the door.  It is device-agnostic: it serves whatever registry it is
handed, and that registry runs on the card unless it was built with
``device="cpu"``.

Four pieces:

:class:`RequestGate`
    Synchronous, thread-safe admission control with an injected clock.
    Per tenant it enforces an **in-flight quota** (``max_inflight``
    admitted-but-unanswered requests) and a **queue-depth cap** (the
    batcher's pending count, sampled at admission).  A request that would
    exceed either is refused at once with a structured backpressure
    response (``overloaded`` / ``queue_full`` + ``retry_after_ms``), never
    queued without bound.  The gate also owns the lifecycle states
    (``loading`` / ``ready`` / ``draining`` / ``unloaded``): a loading
    tenant refuses with a retry hint, a draining tenant or process
    refuses outright.  An accepted request holds an :class:`Admission`;
    ``settle`` gives the outcome (``deadline_expired`` when the answer
    came too late) and frees the slot.

:class:`Frontend`
    The server.  One connection is one closed-loop request stream
    (answers in request order; batching comes from many connections
    feeding one batcher).  The data plane (``query`` / ``insert`` /
    ``delete`` / ``embed``) is admission-gated; the control plane
    (``load`` / ``unload`` / ``update`` / ``health`` / ``stats``) is not.
    ``maintenance`` queues a job on the server's
    :class:`~repro_torch.serve.maintenance.MaintenancePool` (gated at
    submission) and answers its ``job_id`` at once; ``job_status`` polls
    it, so a compaction never holds a connection's request slot or a
    batcher thread.  A query goes through ``MicroBatcher.submit`` under
    the request's trace context, attached only around that synchronous
    call (the tracer's context is thread-local and handler tasks
    interleave on the loop's thread), and the handler awaits the Future
    without blocking the loop.  Blocking ops run in the default executor;
    those threads and the batchers' pump threads launch the index's
    kernels (``dispatch.resolve_device`` pins the index's card for each).
    Every request gets one trace: a retroactive ``request`` span recorded
    when its answer is ready.

:class:`BackgroundServer`
    A Frontend on a loop thread of its own, for a process that goes on
    working (tests, the chip smoke); ``stop`` drains it as SIGTERM does.

:func:`run_server`
    The blocking entry point of ``launch/serve --listen``: SIGTERM and
    SIGINT start the **graceful drain**: stop accepting connections,
    refuse new requests (``shutting_down``), flush the batchers until
    every admitted request is answered, let clients hang up, exit 0.  No
    accepted request is dropped.  Drain budgets are per tenant
    (``tenant_drain_timeouts`` overrides ``drain_timeout_s``).

Tenant lifecycle is WAL-logged (``ServableRegistry.log_lifecycle``) and
traced (``tenant.load`` / ``tenant.unload`` / ``tenant.update`` spans);
``unload`` drains the tenant's in-flight requests before it detaches it,
and a log ending in ``unloaded`` tells recovery the tenant left on
purpose.  ``update`` rebuilds the batcher through
``Servable.make_batcher`` (the arguments ``Servable`` builds it with,
segment-win telemetry included), and an update that changes
``replication`` on a sharded tenant re-places it
(``servable.maintenance.set_replication``: ``static:k`` sets k, ``none``
sets 1 everywhere, ``auto`` waits for the next compaction).

Invariant 9: **the network layer is invisible**.  A wire answer is
bit-equal to the same call made directly, because the server adds no
numerics: the same float32 rows go through the same batcher palette into
the same kernels, and JSON's float64 carries float32 exactly (an
``embed`` answer is copied to the host, then widened to float64).
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import protocol
from .maintenance import MaintenancePool
from .registry import ServableRegistry, _spec_from_manifest

LOADING = "loading"
READY = "ready"
DRAINING = "draining"
UNLOADED = "unloaded"

#: Spec fields ``update`` may change in place (drainable serving knobs);
#: anything else defines the index/embedder family and needs a fresh load.
UPDATABLE_FIELDS = frozenset({"chunk_sizes", "max_delay_ms", "replication"})


class Admission:
    """Token for one accepted request: holds the quota slot until settled."""

    __slots__ = ("tenant", "rows", "t_admit", "deadline", "settled")

    def __init__(self, tenant: str, rows: int, t_admit: float,
                 deadline: Optional[float]):
        self.tenant = tenant
        self.rows = rows
        self.t_admit = t_admit
        self.deadline = deadline
        self.settled = False


class Rejection:
    """A refused request: structured backpressure, never an exception."""

    __slots__ = ("code", "message", "retry_after_ms")

    def __init__(self, code: str, message: str,
                 retry_after_ms: Optional[float] = None):
        self.code = code
        self.message = message
        self.retry_after_ms = retry_after_ms

    def response(self, req_id) -> dict:
        return protocol.error(req_id, self.code, self.message,
                              retry_after_ms=self.retry_after_ms)


class RequestGate:
    """Per-tenant admission control: in-flight quota, queue-depth cap,
    deadlines, lifecycle states.  Pure host-side bookkeeping with an
    injected clock, so every backpressure edge is unit-testable without a
    server or a real clock (``tests/test_torch_frontend_admission.py``).

    Invariants (property-tested in
    ``tests/test_torch_frontend_properties.py``):

    * ``inflight == admitted - settled`` at all times, per tenant;
    * ``inflight <= max_inflight`` -- the quota is never exceeded;
    * a rejected request acquires nothing: no slot, no queue entry;
    * once draining (tenant or process), no new request is admitted.
    """

    def __init__(self, *, max_inflight: int = 64, queue_depth: int = 256,
                 clock=time.monotonic,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 retry_after_ms: float = 25.0):
        if max_inflight < 1 or queue_depth < 1:
            raise ValueError("max_inflight and queue_depth must be >= 1")
        self.max_inflight = int(max_inflight)
        self.queue_depth = int(queue_depth)
        self.clock = clock
        self.metrics = obs_metrics.registry() if metrics is None else metrics
        self.retry_after_ms = float(retry_after_ms)
        self.draining = False               # process-level drain flag
        self._state: Dict[str, str] = {}    # tenant -> lifecycle state
        self._inflight: Counter = Counter()
        self.admitted: Counter = Counter()  # per-tenant admission ledger
        self.rejected: Counter = Counter()
        self.settled: Counter = Counter()
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def set_state(self, tenant: str, state: str) -> None:
        with self._lock:
            if state == UNLOADED:
                self._state.pop(tenant, None)
            else:
                self._state[tenant] = state

    def state(self, tenant: str) -> Optional[str]:
        with self._lock:
            return self._state.get(tenant)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def begin_drain(self) -> None:
        with self._lock:
            self.draining = True

    # -- admission ----------------------------------------------------------

    def _reject(self, tenant: str, reason: str, message: str,
                retryable: bool) -> Rejection:
        self.rejected[tenant] += 1
        self.metrics.inc("frontend_rejects_total", tenant=tenant,
                         reason=reason)
        return Rejection(reason, message,
                         self.retry_after_ms if retryable else None)

    def admit(self, tenant: str, rows: int = 1, queue_depth: int = 0,
              timeout_ms: Optional[float] = None):
        """Try to admit ``rows`` request rows for ``tenant``.

        ``queue_depth`` is the tenant's batcher backlog sampled by the
        caller; ``timeout_ms`` is the client's deadline budget.  Returns
        an :class:`Admission` token or a :class:`Rejection` -- rejection
        is a *return value*, the explicit-backpressure contract.
        """
        now = self.clock()
        with self._lock:
            state = self._state.get(tenant)
            if self.draining:
                return self._reject(tenant, "shutting_down",
                                    "process is draining toward exit",
                                    retryable=False)
            if state is None:
                return self._reject(tenant, "unknown_tenant",
                                    f"no tenant {tenant!r} is served here",
                                    retryable=False)
            if state == LOADING:
                return self._reject(tenant, "loading",
                                    f"tenant {tenant!r} is loading",
                                    retryable=True)
            if state == DRAINING:
                return self._reject(tenant, "draining",
                                    f"tenant {tenant!r} is draining "
                                    "toward unload", retryable=True)
            if timeout_ms is not None and timeout_ms <= 0:
                # the deadline race: a budget that expired in flight (or a
                # nonsensical one) loses at the door, not in the queue
                return self._reject(tenant, "deadline_expired",
                                    "deadline expired before admission",
                                    retryable=False)
            if self._inflight[tenant] >= self.max_inflight:
                return self._reject(
                    tenant, "overloaded",
                    f"tenant {tenant!r} at its in-flight quota "
                    f"({self.max_inflight})", retryable=True)
            if queue_depth >= self.queue_depth:
                return self._reject(
                    tenant, "queue_full",
                    f"tenant {tenant!r} admission queue at its depth cap "
                    f"({self.queue_depth})", retryable=True)
            self._inflight[tenant] += 1
            self.admitted[tenant] += 1
            self.metrics.set("frontend_inflight", self._inflight[tenant],
                             tenant=tenant)
            self.metrics.set("frontend_queue_depth", queue_depth,
                             tenant=tenant)
            deadline = None if timeout_ms is None else now + timeout_ms / 1e3
            return Admission(tenant, int(rows), now, deadline)

    def settle(self, tok: Admission, drained: bool = False) -> str:
        """Release the token's quota slot; returns the request outcome:
        ``"ok"`` or ``"deadline_expired"`` (the answer arrived, but too
        late to be useful -- counted, and reported instead of data)."""
        now = self.clock()
        with self._lock:
            if tok.settled:
                return "ok"
            tok.settled = True
            self._inflight[tok.tenant] -= 1
            self.settled[tok.tenant] += 1
            self.metrics.set("frontend_inflight",
                             self._inflight[tok.tenant], tenant=tok.tenant)
        if drained:
            self.metrics.inc("frontend_drained_requests_total",
                             tenant=tok.tenant)
        if tok.deadline is not None and now > tok.deadline:
            self.metrics.inc("frontend_deadline_expired_total",
                             tenant=tok.tenant)
            return "deadline_expired"
        return "ok"

    # -- introspection -------------------------------------------------------

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight[tenant]

    def total_inflight(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return {"admitted": sum(self.admitted.values()),
                    "rejected": sum(self.rejected.values()),
                    "settled": sum(self.settled.values())}


class Frontend:
    """The async server: connections -> RequestGate -> MicroBatcher.

    Args:
        registry: the (possibly pre-populated) ServableRegistry to serve;
            every registered tenant starts ``ready`` with its pump thread
            running in wall-clock mode.
        max_inflight / queue_depth / retry_after_ms: RequestGate knobs
            (per tenant, uniform across tenants).
        drain_timeout_s: backstop for graceful drain -- how long shutdown
            and unload wait for in-flight requests before forcing.
        tenant_drain_timeouts: per-tenant overrides of ``drain_timeout_s``
            (``{"tenant": seconds}``); tenants not named keep the
            process-wide default.
        maint_workers: background maintenance worker count (None reads
            ``$REPRO_MAINT_WORKERS``, default 1).
    """

    def __init__(self, registry: ServableRegistry, *,
                 max_inflight: int = 64, queue_depth: int = 256,
                 retry_after_ms: float = 25.0,
                 drain_timeout_s: float = 10.0,
                 tenant_drain_timeouts: Optional[Dict[str, float]] = None,
                 maint_workers: Optional[int] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        self.registry = registry
        self.metrics = obs_metrics.registry() if metrics is None else metrics
        self.gate = RequestGate(max_inflight=max_inflight,
                                queue_depth=queue_depth,
                                metrics=self.metrics,
                                retry_after_ms=retry_after_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.tenant_drain_timeouts = {
            str(k): float(v)
            for k, v in (tenant_drain_timeouts or {}).items()}
        self.maintenance = MaintenancePool(registry, workers=maint_workers)
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._lifecycle_lock = threading.Lock()
        self._t_start = time.monotonic()
        for name in registry.names():
            self.gate.set_state(name, READY)

    def drain_timeout_for(self, name: str) -> float:
        """The drain budget for one tenant: its override, else the
        process-wide default."""
        return self.tenant_drain_timeouts.get(name, self.drain_timeout_s)

    # -- server lifecycle ---------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[str, int]:
        """Bind + listen; starts every tenant's wall-clock pump thread.
        Returns the bound (host, port) -- port 0 picks a free one."""
        for name in self.registry.names():
            self.registry.get(name).batcher.start()
        # limit is asyncio's readline buffer cap (default 64 KiB) -- it
        # must admit a full protocol frame or large-but-legal requests
        # (a few hundred embedding rows) die as LimitOverrunError
        self._server = await asyncio.start_server(
            self._handle_conn, host, port,
            limit=protocol.MAX_FRAME_BYTES)
        addr = self._server.sockets[0].getsockname()
        return addr[0], addr[1]

    async def shutdown(self) -> None:
        """Graceful drain: refuse new work, answer everything admitted,
        wait for clients to hang up, then stop the pumps.

        The ordering is the no-lost-request guarantee: the listener closes
        and the gate flips to ``shutting_down`` *before* any batcher
        stops, so every admitted Future still resolves and every handler
        task still writes its response; connections are only force-closed
        after the backstop.  Drain budgets are per tenant: a tenant with
        its own entry in ``tenant_drain_timeouts`` is waited on up to that
        budget, everyone else up to ``drain_timeout_s`` -- one slow tenant
        stretches only its own deadline."""
        self.gate.begin_drain()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        loop = asyncio.get_running_loop()
        t0 = loop.time()

        def _still_draining() -> bool:
            # a tenant still counts while it has in-flight work AND its
            # own budget has not lapsed
            return any(self.gate.inflight(n) > 0
                       and loop.time() - t0 < self.drain_timeout_for(n)
                       for n in self.registry.names())

        while _still_draining():
            await loop.run_in_executor(None, self._flush_all)
            await asyncio.sleep(0.005)
        # admitted work is answered; now let clients read their last
        # responses and hang up (they close on the first drain reject)
        conns_deadline = t0 + max([self.drain_timeout_s,
                                   *self.tenant_drain_timeouts.values()])
        while self._conns and loop.time() < conns_deadline:
            await asyncio.sleep(0.01)
        for writer in list(self._conns):
            writer.close()
        # the pool drains its queue (jobs already submitted complete and
        # stay pollable until exit) before the batchers stop
        await loop.run_in_executor(None, self.maintenance.stop)
        await loop.run_in_executor(None, self._stop_batchers)

    def _flush_all(self) -> None:
        for name in self.registry.names():
            try:
                self.registry.get(name).batcher.flush_all()
            except KeyError:
                pass                       # unloaded underneath us

    def _stop_batchers(self) -> None:
        for name in self.registry.names():
            try:
                self.registry.get(name).batcher.stop()
            except KeyError:
                pass

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.metrics.inc("frontend_connections_total")
        self._conns.add(writer)
        try:
            while True:
                try:
                    line = await reader.readline()
                except (ConnectionResetError, ValueError):
                    # ValueError is how StreamReader.readline surfaces a
                    # frame exceeding MAX_FRAME_BYTES: the stream can't be
                    # re-synchronised, so drop the connection
                    break
                if not line:
                    break
                try:
                    msg = protocol.decode_line(line)
                except (ValueError, UnicodeDecodeError) as e:
                    writer.write(protocol.encode(protocol.error(
                        None, "bad_request", f"undecodable frame: {e}")))
                    await writer.drain()
                    continue
                resp = await self._handle_msg(msg)
                writer.write(protocol.encode(resp))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _handle_msg(self, msg: dict) -> dict:
        req_id = msg.get("id")
        err = protocol.validate_request(msg)
        if err is not None:
            return protocol.error(req_id, "bad_request", err)
        op = msg["op"]
        self.metrics.inc("frontend_requests_total",
                         tenant=msg.get("tenant", "-"), op=op)
        try:
            handler = getattr(self, f"_op_{op}")
            return await handler(req_id, msg)
        except Exception as e:               # noqa: BLE001 -- a request may
            # die, the server never does; the failure travels to the one
            # client that caused it
            return protocol.error(req_id, "internal",
                                  f"{type(e).__name__}: {e}")

    def _servable(self, tenant: str):
        try:
            return self.registry.get(tenant)
        except KeyError:
            return None

    # -- data plane ---------------------------------------------------------

    async def _op_query(self, req_id, msg: dict) -> dict:
        tenant = msg["tenant"]
        sv = self._servable(tenant)
        if sv is None:
            # keep the ledger consistent: unknown tenants reject through
            # the gate (state is absent there too)
            rej = self.gate.admit(tenant, rows=1, queue_depth=0)
            if isinstance(rej, Rejection):
                return rej.response(req_id)
            self.gate.settle(rej)
            return protocol.error(req_id, "unknown_tenant",
                                  f"no tenant {tenant!r} is served here")
        try:
            q = np.asarray(msg["queries"], np.float32)
        except (TypeError, ValueError) as e:
            return protocol.error(req_id, "bad_request",
                                  f"queries are not a float matrix: {e}")
        if q.ndim != 2 or q.shape[1] != sv.spec.n_dims:
            # width must be checked *before* submit: the batcher
            # concatenates rows across requests, and one bad row must not
            # poison a shared batch
            return protocol.error(
                req_id, "bad_request",
                f"queries must be (nq, {sv.spec.n_dims}), got "
                f"{tuple(q.shape)}")
        k = msg["k"]
        n_probes = int(msg.get("n_probes", 1))
        timeout_ms = msg.get("timeout_ms")
        tok = self.gate.admit(tenant, rows=q.shape[0],
                              queue_depth=sv.batcher.pending(),
                              timeout_ms=timeout_ms)
        if isinstance(tok, Rejection):
            return tok.response(req_id)
        tr = obs_trace.tracer()
        ctx = tr.start_trace()
        t0 = tr.clock()
        # attach only around the synchronous submit (never across an
        # await: the tracer context is thread-local and handler tasks
        # interleave on one thread)
        with tr.attach(ctx):
            fut = sv.batcher.submit(q, k, n_probes)
        try:
            gids, dists = await asyncio.wrap_future(fut)
        except Exception as e:               # noqa: BLE001
            self.gate.settle(tok)
            return protocol.error(req_id, "internal",
                                  f"query failed: {type(e).__name__}: {e}")
        outcome = self.gate.settle(tok, drained=self.gate.draining)
        t1 = tr.clock()
        tr.record("request", t0, t1, ctx=ctx, tenant=tenant, op="query",
                  rows=int(q.shape[0]), outcome=outcome)
        self.metrics.observe("frontend_request_latency_s", t1 - t0,
                             tenant=tenant)
        if outcome == "deadline_expired":
            return protocol.error(req_id, "deadline_expired",
                                  "answered past the request deadline")
        return protocol.ok(req_id,
                           gids=np.asarray(gids).tolist(),
                           dists=np.asarray(dists, np.float64).tolist())

    async def _op_insert(self, req_id, msg: dict) -> dict:
        return await self._gated_blocking(
            req_id, msg, rows_of="embeddings",
            call=lambda sv, msg: protocol.ok(req_id, gids=sv.insert(
                np.asarray(msg["embeddings"], np.float32),
                gids=msg.get("gids")).tolist()))

    async def _op_delete(self, req_id, msg: dict) -> dict:
        return await self._gated_blocking(
            req_id, msg, rows_of="gids",
            call=lambda sv, msg: protocol.ok(
                req_id, n_deleted=sv.delete(msg["gids"])))

    async def _op_embed(self, req_id, msg: dict) -> dict:
        return await self._gated_blocking(
            req_id, msg, rows_of="fvals",
            call=lambda sv, msg: protocol.ok(
                req_id, embeddings=sv.embed(
                    np.asarray(msg["fvals"], np.float64)).cpu().numpy()
                .astype(np.float64).tolist()))

    # -- maintenance plane ---------------------------------------------------

    async def _op_maintenance(self, req_id, msg: dict) -> dict:
        """Submit a background maintenance job (async redesign of the old
        blocking ``compact`` verb): admission-gated at submission so a
        draining tenant/process refuses new structural work, but the job
        itself runs on the MaintenancePool -- the response carries a
        ``job_id`` immediately and never occupies a request slot."""
        tenant = msg["tenant"]
        tok = self.gate.admit(tenant, rows=1, queue_depth=0,
                              timeout_ms=msg.get("timeout_ms"))
        if isinstance(tok, Rejection):
            return tok.response(req_id)
        if self._servable(tenant) is None:   # raced an unload past the gate
            self.gate.settle(tok)
            return protocol.error(req_id, "unknown_tenant",
                                  f"no tenant {tenant!r} is served here")
        try:
            job_id = self.maintenance.submit(
                tenant, msg["kind"], **(msg.get("params") or {}))
        except (ValueError, RuntimeError) as e:
            self.gate.settle(tok)
            return protocol.error(req_id, "bad_request", str(e))
        self.gate.settle(tok)
        st = self.maintenance.status(job_id)
        return protocol.ok(req_id, job_id=job_id,
                           state=st["status"] if st else "queued")

    async def _op_job_status(self, req_id, msg: dict) -> dict:
        # ungated: a poll must work even while the process drains (that is
        # how a client learns its submitted job finished)
        st = self.maintenance.status(msg["job_id"])
        if st is None:
            return protocol.error(req_id, "unknown_job",
                                  f"no maintenance job {msg['job_id']!r}")
        return protocol.ok(req_id, **st)

    async def _gated_blocking(self, req_id, msg: dict, rows_of, call) -> dict:
        """Shared shape of the blocking data-plane ops: admit, run in the
        executor under the request trace, settle, answer."""
        tenant = msg["tenant"]
        sv = self._servable(tenant)
        rows = len(msg[rows_of]) if rows_of else 1
        tok = self.gate.admit(tenant, rows=rows, queue_depth=0,
                              timeout_ms=msg.get("timeout_ms"))
        if isinstance(tok, Rejection):
            return tok.response(req_id)
        if sv is None:                       # raced an unload past the gate
            self.gate.settle(tok)
            return protocol.error(req_id, "unknown_tenant",
                                  f"no tenant {tenant!r} is served here")
        tr = obs_trace.tracer()
        ctx = tr.start_trace()
        t0 = tr.clock()
        loop = asyncio.get_running_loop()
        try:
            resp = await loop.run_in_executor(
                None, self._run_traced, ctx, call, sv, msg)
        except ValueError as e:              # library-level validation
            self.gate.settle(tok)
            return protocol.error(req_id, "bad_request", str(e))
        outcome = self.gate.settle(tok, drained=self.gate.draining)
        t1 = tr.clock()
        tr.record("request", t0, t1, ctx=ctx, tenant=tenant,
                  op=msg["op"], rows=rows, outcome=outcome)
        self.metrics.observe("frontend_request_latency_s", t1 - t0,
                             tenant=tenant)
        if outcome == "deadline_expired":
            return protocol.error(req_id, "deadline_expired",
                                  "answered past the request deadline")
        return resp

    @staticmethod
    def _run_traced(ctx, call, sv, msg):
        """Executor shim: re-attach the request's trace context on the
        worker thread so library spans (embed, wal.append, seal) join the
        request's trace instead of minting their own."""
        with obs_trace.tracer().attach(ctx):
            return call(sv, msg)

    # -- control plane ------------------------------------------------------

    async def _op_load(self, req_id, msg: dict) -> dict:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._load_sync,
                                          req_id, msg["spec"])

    def _load_sync(self, req_id, spec_dict: dict) -> dict:
        with self._lifecycle_lock:
            try:
                spec = _spec_from_manifest(dict(spec_dict))
            except (TypeError, ValueError, KeyError) as e:
                return protocol.error(req_id, "bad_request",
                                      f"bad spec: {e}")
            name = spec.name
            if self._servable(name) is not None:
                return protocol.error(req_id, "bad_request",
                                      f"tenant {name!r} already loaded")
            # visible before the (slow) build: concurrent requests get
            # reject-with-retry-after instead of unknown_tenant flapping
            self.gate.set_state(name, LOADING)
            try:
                with obs_trace.tracer().span("tenant.load", tenant=name):
                    sv = self.registry.register(spec)
                    self.registry.log_lifecycle(name, "ready")
                    sv.batcher.start()
            except Exception as e:           # noqa: BLE001
                self.gate.set_state(name, UNLOADED)
                return protocol.error(req_id, "internal",
                                      f"load failed: {e}")
            self.gate.set_state(name, READY)
            return protocol.ok(req_id, tenant=name, state=READY)

    async def _op_unload(self, req_id, msg: dict) -> dict:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._unload_sync,
                                          req_id, msg["tenant"])

    def _unload_sync(self, req_id, name: str) -> dict:
        with self._lifecycle_lock:
            sv = self._servable(name)
            if sv is None:
                return protocol.error(req_id, "unknown_tenant",
                                      f"no tenant {name!r} is served here")
            # draining first: new requests bounce, queued ones finish
            self.gate.set_state(name, DRAINING)
            self.registry.log_lifecycle(name, "draining")
            with obs_trace.tracer().span("tenant.unload", tenant=name):
                drained = self._drain_tenant(sv, name)
                self.registry.log_lifecycle(name, "unloaded")
                self.registry.unregister(name)   # stops the batcher
            self.gate.set_state(name, UNLOADED)
            return protocol.ok(req_id, tenant=name, state=UNLOADED,
                               drained=drained)

    def _drain_tenant(self, sv, name: str) -> bool:
        """Answer everything admitted for one tenant (True if fully
        drained inside the backstop).  Runs on an executor thread, so the
        event loop keeps settling handler tasks while we wait."""
        deadline = time.monotonic() + self.drain_timeout_for(name)
        sv.batcher.flush_all()
        while self.gate.inflight(name) > 0 and time.monotonic() < deadline:
            sv.batcher.flush_all()
            time.sleep(0.005)
        return self.gate.inflight(name) == 0

    async def _op_update(self, req_id, msg: dict) -> dict:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._update_sync,
                                          req_id, msg["spec"])

    def _update_sync(self, req_id, spec_dict: dict) -> dict:
        with self._lifecycle_lock:
            try:
                spec = _spec_from_manifest(dict(spec_dict))
            except (TypeError, ValueError, KeyError) as e:
                return protocol.error(req_id, "bad_request",
                                      f"bad spec: {e}")
            name = spec.name
            sv = self._servable(name)
            if sv is None:
                return protocol.error(req_id, "unknown_tenant",
                                      f"no tenant {name!r} is served here")
            changed = {f.name for f in dataclasses.fields(sv.spec)
                       if getattr(sv.spec, f.name) != getattr(spec, f.name)}
            illegal = changed - UPDATABLE_FIELDS
            if illegal:
                return protocol.error(
                    req_id, "bad_request",
                    f"update may only change {sorted(UPDATABLE_FIELDS)}; "
                    f"{sorted(illegal)} define the index family -- unload "
                    f"and load a new tenant instead")
            # requests during the swap get reject-with-retry-after
            self.gate.set_state(name, LOADING)
            with obs_trace.tracer().span("tenant.update", tenant=name):
                old = sv.batcher
                old.stop()                   # drains the queued requests
                self._drain_tenant(sv, name)
                sv.spec = spec
                sv.batcher = sv.make_batcher(spec)
                policy = spec.replication_policy()
                if "replication" in changed and policy != "auto" \
                        and sv.index.shard_layout() is not None:
                    sv.maintenance.set_replication(policy)
                self.registry.log_lifecycle(name, "updated")
                sv.batcher.start()
            self.gate.set_state(name, READY)
            return protocol.ok(req_id, tenant=name, state=READY,
                               changed=sorted(changed))

    # -- health / stats -----------------------------------------------------

    async def _op_health(self, req_id, msg: dict) -> dict:
        tenants = {}
        for name, state in sorted(self.gate.states().items()):
            sv = self._servable(name)
            tenants[name] = {
                "state": state,
                "inflight": self.gate.inflight(name),
                "queue_depth": sv.batcher.pending() if sv else 0,
            }
        return protocol.ok(req_id, tenants=tenants,
                           draining=self.gate.draining,
                           uptime_s=round(time.monotonic()
                                          - self._t_start, 3),
                           totals=self.gate.totals())

    async def _op_stats(self, req_id, msg: dict) -> dict:
        tenant = msg.get("tenant")
        loop = asyncio.get_running_loop()
        if tenant is not None:
            sv = self._servable(tenant)
            if sv is None:
                return protocol.error(req_id, "unknown_tenant",
                                      f"no tenant {tenant!r} is served here")
            report = await loop.run_in_executor(None, sv.report)
            return protocol.ok(req_id, report=report)
        report = await loop.run_in_executor(None, self.registry.report)
        return protocol.ok(
            req_id, report=report,
            metrics=self.metrics.summary(),
            catalog=sorted(self.metrics.catalog))


class BackgroundServer:
    """A :class:`Frontend` served on an asyncio loop in a thread of its own,
    for a process that goes on doing other work (tests, the chip smoke):
    ``host`` / ``port`` are the bound address (port 0 picks a free one).
    :meth:`stop` drains the server as :func:`run_server` does, joins the
    loop's executor threads, then stops and joins the loop's thread,
    raising if it outlives ``timeout_s``.  ``kw`` are the Frontend's."""

    def __init__(self, registry: ServableRegistry, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 300.0, **kw):
        self.frontend = Frontend(registry, **kw)
        self.timeout_s = float(timeout_s)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True, name="frontend-loop")
        self._thread.start()
        try:
            self.host, self.port = self._call(self.frontend.start(host,
                                                                  port))
        except BaseException:
            self._close()
            raise

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            self.timeout_s)

    def client(self, timeout_s: float = 120.0):
        """A new :class:`~repro_torch.serve.client.FrontendClient`."""
        from .client import FrontendClient
        return FrontendClient(self.host, self.port, timeout_s=timeout_s)

    def stop(self) -> None:
        """Graceful drain, then the loop and its threads stopped."""
        try:
            self._call(self.frontend.shutdown())
            self._call(self._loop.shutdown_default_executor())
        finally:
            self._close()

    def _close(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(self.timeout_s)
        if self._thread.is_alive():
            raise TimeoutError(f"front-end loop still running after "
                               f"{self.timeout_s}s")
        self._loop.close()

    def __enter__(self) -> "BackgroundServer":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def run_server(registry: ServableRegistry, host: str = "127.0.0.1",
               port: int = 0, *, max_inflight: int = 64,
               queue_depth: int = 256, retry_after_ms: float = 25.0,
               drain_timeout_s: float = 10.0,
               tenant_drain_timeouts: Optional[Dict[str, float]] = None,
               maint_workers: Optional[int] = None, exporter=None,
               flush_interval_s: float = 0.5) -> Dict[str, int]:
    """Serve ``registry`` until SIGTERM/SIGINT, then drain gracefully.

    Blocking; returns the gate's final totals (admitted/rejected/settled)
    after the drain completes.  Prints ``[frontend] listening on H:P``
    once bound -- the line the test harness and load generator wait for --
    and a drain report on the way out.
    """

    async def _main() -> Dict[str, int]:
        import signal

        fe = Frontend(registry, max_inflight=max_inflight,
                      queue_depth=queue_depth,
                      retry_after_ms=retry_after_ms,
                      drain_timeout_s=drain_timeout_s,
                      tenant_drain_timeouts=tenant_drain_timeouts,
                      maint_workers=maint_workers)
        h, p = await fe.start(host, port)
        print(f"[frontend] listening on {h}:{p}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        flusher = None
        if exporter is not None:
            async def _flush_loop():
                while True:
                    await asyncio.sleep(flush_interval_s)
                    exporter.flush()
            flusher = asyncio.ensure_future(_flush_loop())
        await stop.wait()
        print("[frontend] draining ...", flush=True)
        await fe.shutdown()
        if flusher is not None:
            flusher.cancel()
        if exporter is not None:
            exporter.flush()
        totals = fe.gate.totals()
        print(f"[frontend] drained: admitted={totals['admitted']} "
              f"settled={totals['settled']} "
              f"rejected={totals['rejected']} "
              f"inflight={fe.gate.total_inflight()}", flush=True)
        return totals

    return asyncio.run(_main())
