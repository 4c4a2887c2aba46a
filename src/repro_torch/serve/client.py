"""Blocking client library for the serving front-end.

The port's own copy of ``repro/serve/client.py`` (numpy and the standard
library; the port imports nothing of the JAX package).  It speaks
:mod:`repro_torch.serve.protocol`, which is the JAX package's protocol
byte for byte, so it talks to either package's server.

One :class:`FrontendClient` wraps one TCP connection in closed-loop,
request/response order.  The server batches *across* connections, so a
load generator opens one client per concurrent stream; a single client
never sees its own requests coalesced.

Error handling has two layers on purpose:

* :meth:`FrontendClient.request` returns the raw response dict,
  rejections included: load generators and tests read ``ok`` / ``code`` /
  ``retry_after_ms`` themselves to *count* backpressure instead of
  crashing on it;
* the typed wrappers (:meth:`~FrontendClient.query_arrays`,
  :meth:`~FrontendClient.insert`, ...) raise :class:`FrontendError` on any
  non-ok response, carrying the structured code.

Thread-safe per instance (one lock around each write/read pair); float32
arrays go to and from JSON lists losslessly, which keeps the wire-parity
contract (invariant 9).
"""

from __future__ import annotations

import dataclasses
import itertools
import socket
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

from . import protocol


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped-exponential retry schedule for structured backpressure.

    The front-end's rejections carry ``retry_after_ms`` -- the server's own
    estimate of when capacity frees up.  :func:`request_with_retries` waits
    ``max(base_ms * 2^attempt, retry_after_ms)`` (clipped to ``cap_ms``)
    between attempts: the hint is honored as a *floor* (retrying sooner
    than the server asked just feeds the storm) while the exponential term
    keeps repeated rejections backing off even when the hint stays flat.
    Deliberately jitter-free: one policy always produces one schedule, so
    tests assert exact sleep sequences; fleet-scale jitter belongs in the
    caller's choice of ``base_ms``, not hidden randomness.
    """

    max_attempts: int = 5           # total send attempts (first one included)
    base_ms: float = 10.0
    cap_ms: float = 1000.0
    # structured codes worth retrying: transient capacity, not semantics
    retryable: Tuple[str, ...] = ("overloaded", "queue_full")

    def backoff_ms(self, attempt: int,
                   retry_after_ms: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (0-based), honoring the
        server hint as a floor and ``cap_ms`` as the ceiling."""
        sched = self.base_ms * (2.0 ** attempt)
        if retry_after_ms:
            sched = max(sched, float(retry_after_ms))
        return min(sched, self.cap_ms)


def request_with_retries(send: Callable[[], dict],
                         policy: RetryPolicy = RetryPolicy(),
                         sleep: Callable[[float], None] = time.sleep
                         ) -> Tuple[dict, int]:
    """Run ``send()`` until it returns ok / a non-retryable rejection / the
    attempt budget runs out.

    Args:
        send: zero-arg callable issuing one raw request (e.g.
            ``lambda: client.query(tenant, q, k)``).
        policy: the backoff schedule; rejections whose ``code`` is not in
            ``policy.retryable`` are returned immediately.
        sleep: injectable for tests (receives seconds).

    Returns:
        ``(response, n_retries)`` -- the final response (the caller still
        inspects ``ok``; the last attempt may itself be a rejection) and
        how many retries were spent on it.
    """
    resp = send()
    retries = 0
    while (not resp.get("ok")
           and resp.get("code") in policy.retryable
           and retries < policy.max_attempts - 1):
        sleep(policy.backoff_ms(retries, resp.get("retry_after_ms")) / 1e3)
        resp = send()
        retries += 1
    return resp, retries


class FrontendError(RuntimeError):
    """A non-ok response, carrying the protocol's structured fields."""

    def __init__(self, resp: dict):
        super().__init__(f"[{resp.get('code')}] {resp.get('error')}")
        self.code = resp.get("code")
        self.retry_after_ms = resp.get("retry_after_ms")
        self.response = resp


class FrontendClient:
    """One connection to a front-end server.

    Args:
        host / port: where the server printed
            ``[frontend] listening on H:P``.
        timeout_s: socket timeout for connect and each response read.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._f = self._sock.makefile("rwb")
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # -- transport ----------------------------------------------------------

    def request(self, op: str, **fields) -> dict:
        """Send one request, read its response (raw dict, rejects and
        all).  Raises ConnectionError if the server hung up mid-request --
        which graceful drain guarantees never happens to an *accepted*
        request."""
        req_id = next(self._ids)
        msg = {"id": req_id, "op": op, **fields}
        with self._lock:
            self._f.write(protocol.encode(msg))
            self._f.flush()
            line = self._f.readline()
        if not line:
            raise ConnectionError(
                f"server closed the connection awaiting response {req_id}")
        resp = protocol.decode_line(line)
        if resp.get("id") not in (req_id, None):
            raise ConnectionError(
                f"response id {resp.get('id')} for request {req_id}")
        return resp

    def _checked(self, op: str, **fields) -> dict:
        resp = self.request(op, **fields)
        if not resp.get("ok"):
            raise FrontendError(resp)
        return resp

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "FrontendClient":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- data plane ---------------------------------------------------------

    def query(self, tenant: str, queries, k: int, n_probes: int = 1,
              timeout_ms: Optional[float] = None) -> dict:
        """Raw query response (inspect ``ok``/``code`` yourself)."""
        fields = {"tenant": tenant,
                  "queries": np.asarray(queries,
                                        np.float32).tolist(),
                  "k": int(k), "n_probes": int(n_probes)}
        if timeout_ms is not None:
            fields["timeout_ms"] = float(timeout_ms)
        return self.request("query", **fields)

    def query_with_retries(self, tenant: str, queries, k: int,
                           n_probes: int = 1,
                           policy: RetryPolicy = RetryPolicy(),
                           sleep: Callable[[float], None] = time.sleep
                           ) -> Tuple[dict, int]:
        """:meth:`query` through :func:`request_with_retries`: backpressure
        rejections (``overloaded``/``queue_full``) are retried on the
        policy's schedule, honoring the server's ``retry_after_ms`` hint.
        Returns (final raw response, retries spent)."""
        return request_with_retries(
            lambda: self.query(tenant, queries, k, n_probes=n_probes),
            policy=policy, sleep=sleep)

    def query_arrays(self, tenant: str, queries, k: int,
                     n_probes: int = 1,
                     timeout_ms: Optional[float] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Query -> (gids (nq, k) int32, dists (nq, k) float32); raises
        FrontendError on rejection.  The returned arrays are bit-identical
        to a direct ``SegmentedIndex.query`` against the same state."""
        resp = self.query(tenant, queries, k, n_probes=n_probes,
                          timeout_ms=timeout_ms)
        if not resp.get("ok"):
            raise FrontendError(resp)
        return (np.asarray(resp["gids"], np.int32),
                np.asarray(resp["dists"], np.float32))

    def insert(self, tenant: str, embeddings, gids=None) -> np.ndarray:
        fields = {"tenant": tenant,
                  "embeddings": np.asarray(embeddings,
                                           np.float32).tolist()}
        if gids is not None:
            fields["gids"] = np.asarray(gids, np.int32).tolist()
        resp = self._checked("insert", **fields)
        return np.asarray(resp["gids"], np.int32)

    def delete(self, tenant: str, gids) -> int:
        resp = self._checked("delete", tenant=tenant,
                             gids=np.asarray(gids, np.int32).tolist())
        return int(resp["n_deleted"])

    def embed(self, tenant: str, fvals) -> np.ndarray:
        resp = self._checked("embed", tenant=tenant,
                             fvals=np.asarray(fvals,
                                              np.float64).tolist())
        return np.asarray(resp["embeddings"], np.float32)

    # -- maintenance plane ---------------------------------------------------

    def maintenance(self, tenant: str, kind: str, **params) -> str:
        """Submit an async maintenance job; returns its ``job_id``
        immediately (the job runs on the server's background pool)."""
        fields = {"tenant": tenant, "kind": kind}
        if params:
            fields["params"] = params
        return str(self._checked("maintenance", **fields)["job_id"])

    def job_status(self, job_id: str) -> dict:
        """One poll of a submitted job: ``{"status": queued|running|done|
        failed, "result": ..., "error": ...}``."""
        return self._checked("job_status", job_id=job_id)

    def wait_job(self, job_id: str, timeout_s: float = 30.0,
                 interval_s: float = 0.02) -> dict:
        """Poll until the job reaches a terminal state; returns the final
        status dict.  Raises FrontendError if the job *failed* (carrying
        the server-side error) and TimeoutError if it never settled."""
        deadline = time.monotonic() + timeout_s
        while True:
            st = self.job_status(job_id)
            if st["status"] == "done":
                return st
            if st["status"] == "failed":
                raise FrontendError({"code": "internal",
                                     "error": st.get("error"), **st})
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"maintenance job {job_id} still {st['status']} "
                    f"after {timeout_s}s")
            time.sleep(interval_s)

    def compact(self, tenant: str, timeout_s: float = 30.0) -> int:
        """Synchronous compaction, kept for convenience: submits an async
        ``maintenance`` job and polls it to completion (the blocking wire
        verb is gone -- this costs the same one background job)."""
        job_id = self.maintenance(tenant, "compact")
        st = self.wait_job(job_id, timeout_s=timeout_s)
        return int(st["result"]["n_live"])

    # -- control plane ------------------------------------------------------

    def load(self, spec: dict) -> dict:
        return self._checked("load", spec=spec)

    def unload(self, tenant: str) -> dict:
        return self._checked("unload", tenant=tenant)

    def update(self, spec: dict) -> dict:
        return self._checked("update", spec=spec)

    def health(self) -> dict:
        return self._checked("health")

    def stats(self, tenant: Optional[str] = None) -> dict:
        if tenant is None:
            return self._checked("stats")
        return self._checked("stats", tenant=tenant)


def wait_ready(host: str, port: int, timeout_s: float = 30.0,
               interval_s: float = 0.1) -> None:
    """Poll until the server accepts connections and answers ``health``
    (used after parsing the listening line, before traffic starts)."""
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            with FrontendClient(host, port, timeout_s=5.0) as c:
                c.health()
            return
        except (OSError, FrontendError, ValueError) as e:
            last = e
            time.sleep(interval_s)
    raise TimeoutError(
        f"front-end at {host}:{port} not ready in {timeout_s}s: {last}")
