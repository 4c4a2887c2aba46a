"""Wire protocol of the serving front-end: newline-delimited JSON frames.

The port's own copy of ``repro/serve/protocol.py`` (standard library
only; the port imports nothing of the JAX package).  Frames, codes and ops
are the JAX package's, byte for byte, so either package's client talks to
either package's server.

One request, one response, in order, per connection: the closed-loop
discipline the micro-batcher wants (requests coalesce across *many
connections*, not by pipelining within one).  A frame is one JSON object
ended by ``\\n`` (``json.dumps`` never emits a raw newline), so the
protocol can be read with ``nc`` and any language's line reader.

A request carries ``{"id": <client-chosen int>, "op": <str>, ...}``; its
response echoes the ``id`` and carries ``"ok": true`` and the op's fields,
or ``"ok": false`` with a ``code`` from :data:`CODES` (and
``retry_after_ms`` when the right reaction is to back off and retry: the
explicit-backpressure half of admission control).

Arrays (query and insert embeddings, answered gids and distances) travel
as JSON lists of numbers.  float32 -> float64 -> float32 round-trips
exactly, so a wire answer is bit-equal to the same call made directly
(invariant 9: the network layer is invisible).

Ops (see :class:`~repro_torch.serve.frontend.Frontend`):

=============  ==========================================================
``query``       tenant, queries (nq, N), k, n_probes?, timeout_ms?
``insert``      tenant, embeddings (m, N), gids?
``delete``      tenant, gids
``embed``       tenant, fvals -> embeddings (the tenant's embedder)
``maintenance`` tenant, kind (:data:`MAINTENANCE_KINDS`), params? --
                queues a background job, answers its ``job_id``
``job_status``  job_id -> status (queued|running|done|failed) + result
``load``        spec (ServableSpec dict): register and ready a new tenant
``unload``      tenant: drain its in-flight requests, then detach
``update``      spec: in-place update of the drainable knobs (same name)
``health``      -> lifecycle states, in-flight counts, queue depths, uptime
``stats``       tenant? -> ServingStats snapshot + metrics summary
=============  ==========================================================

:data:`MAINTENANCE_KINDS` is the port's ``serve.maintenance.KINDS``:
``seal``, ``compact`` and ``set_replication`` (``params``: ``replication``,
None, an int or factors per sealed segment), the JAX package's kinds.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional

#: A frame larger than this is a protocol violation, not a big request --
#: reject instead of buffering unboundedly (backpressure applies to memory
#: too).
MAX_FRAME_BYTES = 64 << 20

#: Machine-readable rejection codes (the ``code`` field of error
#: responses).  ``retryable`` codes carry ``retry_after_ms``: the request
#: was well-formed, the server just refuses it *right now*.
CODES = {
    "overloaded":       {"retryable": True,
                         "help": "tenant in-flight quota exhausted"},
    "queue_full":       {"retryable": True,
                         "help": "tenant admission queue at its depth cap"},
    "loading":          {"retryable": True,
                         "help": "tenant is loading; retry shortly"},
    "draining":         {"retryable": True,
                         "help": "tenant is draining toward unload"},
    "shutting_down":    {"retryable": False,
                         "help": "process is draining toward exit"},
    "unknown_tenant":   {"retryable": False,
                         "help": "no tenant of that name is served here"},
    "deadline_expired": {"retryable": False,
                         "help": "the request's deadline passed"},
    "bad_request":      {"retryable": False,
                         "help": "malformed frame or fields"},
    "unknown_job":      {"retryable": False,
                         "help": "no maintenance job with that id"},
    "internal":         {"retryable": False,
                         "help": "server-side failure; see error"},
}

#: Ops a request may carry (validated before dispatch).
OPS = ("query", "insert", "delete", "embed", "maintenance", "job_status",
       "load", "unload", "update", "health", "stats")

#: Job kinds the ``maintenance`` verb accepts: the port's
#: ``serve.maintenance.KINDS`` (tests hold the two equal).
MAINTENANCE_KINDS = ("seal", "compact", "set_replication")


def encode(msg: dict) -> bytes:
    """One frame: compact JSON + newline."""
    return json.dumps(msg, separators=(",", ":")).encode("utf-8") + b"\n"


def decode_line(line: bytes) -> dict:
    """Parse one frame; raises ValueError on anything but a JSON object."""
    if len(line) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(line)}B exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    msg = json.loads(line.decode("utf-8"))
    if not isinstance(msg, dict):
        raise ValueError(f"frame must be a JSON object, got {type(msg)}")
    return msg


def ok(req_id, **fields) -> dict:
    return {"id": req_id, "ok": True, **fields}


def error(req_id, code: str, message: str,
          retry_after_ms: Optional[float] = None) -> dict:
    """A structured rejection (*the* backpressure signal: the client is
    told exactly why and, when retryable, when to come back)."""
    if code not in CODES:
        raise ValueError(f"unknown error code {code!r}")
    resp = {"id": req_id, "ok": False, "code": code, "error": message}
    if retry_after_ms is not None:
        resp["retry_after_ms"] = round(float(retry_after_ms), 3)
    return resp


def validate_request(msg: dict) -> Optional[str]:
    """Structural validation shared by server and tests; returns an error
    string (-> ``bad_request``) or None when the frame is well-formed."""
    op = msg.get("op")
    if op not in OPS:
        return f"op must be one of {OPS}, got {op!r}"
    if "id" in msg and not isinstance(msg["id"], (int, str)):
        return "id must be an int or string"
    if op in ("query", "insert", "delete", "embed", "maintenance",
              "unload"):
        if not isinstance(msg.get("tenant"), str):
            return f"{op} needs a string 'tenant'"
    if op == "maintenance":
        if msg.get("kind") not in MAINTENANCE_KINDS:
            return (f"maintenance needs a 'kind' in {MAINTENANCE_KINDS}, "
                    f"got {msg.get('kind')!r}")
        if "params" in msg and not isinstance(msg["params"], dict):
            return "maintenance 'params' must be a dict when present"
    if op == "job_status" and not isinstance(msg.get("job_id"), str):
        return "job_status needs a string 'job_id'"
    if op == "query":
        if not isinstance(msg.get("queries"), list) or not msg["queries"]:
            return "query needs a non-empty 'queries' list of rows"
        if not isinstance(msg.get("k"), int) or msg["k"] < 1:
            return "query needs an int 'k' >= 1"
    if op == "insert" and not isinstance(msg.get("embeddings"), list):
        return "insert needs an 'embeddings' list of rows"
    if op == "delete" and not isinstance(msg.get("gids"), list):
        return "delete needs a 'gids' list"
    if op == "embed" and not isinstance(msg.get("fvals"), list):
        return "embed needs an 'fvals' list of rows"
    if op in ("load", "update") and not isinstance(msg.get("spec"), dict):
        return f"{op} needs a 'spec' dict (ServableSpec fields)"
    return None


class FrameDecoder:
    """Incremental newline-frame splitter for raw byte streams.

    The asyncio server uses ``readline`` directly; this exists for
    transports that hand you arbitrary chunks (and for tests to fuzz
    fragmentation): ``feed`` returns every complete frame, buffering the
    remainder."""

    def __init__(self):
        self._buf = b""

    def feed(self, data: bytes) -> Iterator[dict]:
        self._buf += data
        if len(self._buf) > MAX_FRAME_BYTES:
            raise ValueError("unterminated frame exceeds MAX_FRAME_BYTES")
        frames: List[dict] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            line, self._buf = self._buf[:nl + 1], self._buf[nl + 1:]
            if line.strip():
                frames.append(decode_line(line))
        return iter(frames)
