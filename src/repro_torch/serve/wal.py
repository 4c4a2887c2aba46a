"""Per-tenant write-ahead delta log: the durable half of the write path.

The port of ``repro/serve/wal.py``.  Its files are the JAX package's, byte
for byte: the same operations give the same bytes from either package, and
either package reads and replays the other's logs.  Every mutation is
framed, checksummed and appended **before** it is applied, so a recovering
process replays ``snapshot + WAL tail`` and lands bit-identical to the run
that never crashed (the JAX package's invariant 7).

Record framing (little-endian)::

    frame   := length:u32 | crc32:u32 | payload[length]
    payload := op:u8 | body

    op 0 REGISTER         body = JSON ServableSpec dict (utf-8)
    op 1 INSERT           body = n:u32 | d:u32 | gids:int32[n] | emb:f32[n*d]
    op 2 DELETE           body = n:u32 | gids:int32[n]
    op 3 SEAL             body = empty
    op 4 COMPACT          body = empty
    op 5 SET_REPLICATION  body = JSON policy (null | int | [int, ...])
    op 6 LIFECYCLE        body = JSON {"state": "loading" | "ready" |
                                 "draining" | "unloaded" | "updated"}

``crc32`` covers the payload, so :func:`read_wal` detects a **truncated
tail** (a crash mid-append) and a **corrupt record** (crc mismatch); either
way it stops at the first bad frame, reports its offset and reason, and
returns every record before it.

Group commit: each append is flushed to the OS (a killed *process* loses
nothing) but fsync'd only every ``fsync_every`` records (a killed
*machine* loses at most one group).  ``fsync_every=1`` is synchronous
commit; ``0`` leaves fsync to explicit ``sync()`` calls (snapshot points).
The default comes from ``$REPRO_WAL_FSYNC_EVERY`` (8).

Fault sites (``serve/faults.py``): ``wal.append`` between the header and
payload writes (a ``kill`` there leaves a torn frame), ``wal.appended``
after the flush, ``wal.fsync`` / ``wal.fsynced`` around the fsync.

Telemetry, as the JAX package's: each append runs under a ``wal.append``
span and each fsync under ``wal.fsync``, and they count
``wal_appends_total``, ``wal_bytes_total`` (frame headers included: the
file's bytes), ``wal_fsyncs_total``, ``wal_append_latency_s`` and
``wal_fsync_latency_s``, labelled by the log's tenant (its basename).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import faults

_ENV_FSYNC_EVERY = "REPRO_WAL_FSYNC_EVERY"
_HEADER = struct.Struct("<II")           # (payload length, payload crc32)

OP_REGISTER = 0
OP_INSERT = 1
OP_DELETE = 2
OP_SEAL = 3
OP_COMPACT = 4
OP_SET_REPLICATION = 5
OP_LIFECYCLE = 6

OP_NAMES = {OP_REGISTER: "register", OP_INSERT: "insert",
            OP_DELETE: "delete", OP_SEAL: "seal", OP_COMPACT: "compact",
            OP_SET_REPLICATION: "set_replication",
            OP_LIFECYCLE: "lifecycle"}

#: Servable lifecycle states a LIFECYCLE record may carry.
LIFECYCLE_STATES = ("loading", "ready", "draining", "unloaded", "updated")


@dataclasses.dataclass
class WalRecord:
    """One decoded log record (fields unused by the op are None)."""

    op: int
    gids: Optional[np.ndarray] = None          # int32 (insert / delete)
    embeddings: Optional[np.ndarray] = None    # f32 (n, d) (insert)
    value: Any = None                          # JSON payload

    @property
    def op_name(self) -> str:
        return OP_NAMES.get(self.op, f"op{self.op}")


# -- payload encode/decode ---------------------------------------------------


def encode_register(spec_dict: dict) -> bytes:
    return bytes([OP_REGISTER]) + json.dumps(spec_dict).encode()


def encode_insert(gids: np.ndarray, embeddings: np.ndarray) -> bytes:
    """``gids`` int32 and ``embeddings`` (n, d) f32 as host numpy: the
    rows the index stores, little-endian."""
    gids = np.ascontiguousarray(gids, "<i4")
    emb = np.ascontiguousarray(embeddings, "<f4")
    n, d = emb.shape
    return (bytes([OP_INSERT]) + struct.pack("<II", n, d)
            + gids.tobytes() + emb.tobytes())


def encode_delete(gids: np.ndarray) -> bytes:
    gids = np.ascontiguousarray(gids, "<i4")
    return bytes([OP_DELETE]) + struct.pack("<I", gids.size) + gids.tobytes()


def encode_seal() -> bytes:
    return bytes([OP_SEAL])


def encode_compact() -> bytes:
    return bytes([OP_COMPACT])


def encode_set_replication(policy) -> bytes:
    policy = list(policy) if isinstance(policy, (tuple, list)) else policy
    return bytes([OP_SET_REPLICATION]) + json.dumps(policy).encode()


def encode_lifecycle(state: str) -> bytes:
    """A servable lifecycle transition.  Replay treats it as a no-op on
    the index; recovery skips a tenant whose last state is "unloaded"."""
    if state not in LIFECYCLE_STATES:
        raise ValueError(
            f"lifecycle state must be one of {LIFECYCLE_STATES}, "
            f"got {state!r}")
    return bytes([OP_LIFECYCLE]) + json.dumps({"state": state}).encode()


def decode_payload(payload: bytes) -> WalRecord:
    """Decode one payload; raises ValueError on a malformed body (treated
    by :func:`read_wal` like a crc failure: the frame is bad)."""
    if not payload:
        raise ValueError("empty payload")
    op, body = payload[0], payload[1:]
    if op == OP_INSERT:
        if len(body) < 8:
            raise ValueError("insert body shorter than its (n, d) header")
        n, d = struct.unpack_from("<II", body)
        want = 8 + 4 * n + 4 * n * d
        if len(body) != want:
            raise ValueError(f"insert body {len(body)}B, want {want}B "
                             f"for n={n} d={d}")
        gids = np.frombuffer(body, "<i4", count=n, offset=8)
        emb = np.frombuffer(body, "<f4", count=n * d,
                            offset=8 + 4 * n).reshape(n, d)
        return WalRecord(OP_INSERT, gids=gids, embeddings=emb)
    if op == OP_DELETE:
        if len(body) < 4:
            raise ValueError("delete body shorter than its count header")
        (n,) = struct.unpack_from("<I", body)
        if len(body) != 4 + 4 * n:
            raise ValueError(f"delete body {len(body)}B, want {4 + 4 * n}B")
        return WalRecord(OP_DELETE,
                         gids=np.frombuffer(body, "<i4", count=n, offset=4))
    if op in (OP_SEAL, OP_COMPACT):
        if body:
            raise ValueError(f"{OP_NAMES[op]} body must be empty")
        return WalRecord(op)
    if op in (OP_REGISTER, OP_SET_REPLICATION, OP_LIFECYCLE):
        return WalRecord(op, value=json.loads(body.decode()))
    raise ValueError(f"unknown op {op}")


# -- the log -----------------------------------------------------------------


def default_fsync_every() -> int:
    try:
        return max(0, int(os.environ.get(_ENV_FSYNC_EVERY, "8")))
    except ValueError:
        return 8


class WriteAheadLog:
    """Append-only framed log with group-commit fsync.

    Args:
        path: log file (created, parents included; an existing log is
            opened for append -- recovery reattaches to the same file).
        fsync_every: fsync after this many appends (1 = every record,
            0 = only on explicit ``sync()``); default from
            ``$REPRO_WAL_FSYNC_EVERY``.
    """

    def __init__(self, path: str, fsync_every: Optional[int] = None):
        self.path = path
        self.fsync_every = (default_fsync_every() if fsync_every is None
                            else max(0, int(fsync_every)))
        # the metric and span label: the registry names a tenant's log
        # <name>.wal
        self.tenant = os.path.splitext(os.path.basename(path))[0]
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self.offset = self._f.tell()      # bytes in the log
        self.appends = 0
        self.syncs = 0
        self._pending = 0

    def append(self, payload: bytes) -> int:
        """Frame and append one payload; returns the offset after it.

        The header is flushed before the payload is written, so a ``kill``
        at ``wal.append`` leaves a header whose payload never arrived:
        the torn frame replay must survive."""
        tr = obs_trace.tracer()
        t0 = tr.clock()
        size = _HEADER.size + len(payload)
        with tr.span("wal.append", tenant=self.tenant, bytes=size):
            self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
            self._f.flush()
            faults.fire("wal.append")
            self._f.write(payload)
            self._f.flush()
            faults.fire("wal.appended")
        self.offset += size
        self.appends += 1
        self._pending += 1
        reg = obs_metrics.registry()
        reg.inc("wal_appends_total", tenant=self.tenant)
        reg.inc("wal_bytes_total", size, tenant=self.tenant)
        reg.observe("wal_append_latency_s", tr.clock() - t0,
                    tenant=self.tenant)
        if self.fsync_every and self._pending >= self.fsync_every:
            self.sync()
        return self.offset

    def sync(self) -> None:
        """Group-commit point: everything appended so far becomes durable."""
        tr = obs_trace.tracer()
        t0 = tr.clock()
        with tr.span("wal.fsync", tenant=self.tenant,
                     pending=self._pending):
            self._f.flush()
            faults.fire("wal.fsync")
            os.fsync(self._f.fileno())
            faults.fire("wal.fsynced")
        self._pending = 0
        self.syncs += 1
        reg = obs_metrics.registry()
        reg.inc("wal_fsyncs_total", tenant=self.tenant)
        reg.observe("wal_fsync_latency_s", tr.clock() - t0,
                    tenant=self.tenant)

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def stats(self) -> dict:
        return {"path": self.path, "offset": self.offset,
                "appends": self.appends, "syncs": self.syncs,
                "fsync_every": self.fsync_every}


class WalFollower:
    """Incremental cursor over a (possibly still growing) WAL file: the
    warm standby's read half.

    Each :meth:`poll` decodes the records appended since the last one and
    moves the cursor to the end of the clean prefix.  A torn tail (the
    primary crashed, or is between the two flushes of an append) leaves
    the cursor before the bad frame, so the next poll retries it.  A file
    that does not exist yet polls empty.
    """

    def __init__(self, path: str, start: int = 0):
        self.path = path
        self.offset = int(start)
        self.records_seen = 0

    def poll(self) -> Tuple[List[WalRecord], dict]:
        """The records appended since the last poll, and ``read_wal``'s
        report; the cursor moves to its ``end_offset``."""
        if not os.path.exists(self.path):
            return [], {"n_records": 0, "end_offset": self.offset,
                        "wal_bytes": 0, "truncated": False,
                        "bad_frame_at": None, "bad_frame_reason": None}
        records, report = read_wal(self.path, start=self.offset)
        self.offset = report["end_offset"]
        self.records_seen += len(records)
        return records, report

    def lag_bytes(self) -> int:
        """File bytes past the cursor (0 when caught up or no file)."""
        if not os.path.exists(self.path):
            return 0
        return max(0, os.path.getsize(self.path) - self.offset)


def read_wal(path: str, start: int = 0) -> Tuple[List[WalRecord], dict]:
    """Decode records from ``path`` starting at byte ``start``.

    Returns ``(records, report)``.  The first bad frame -- short header,
    payload shorter than promised, crc mismatch or an undecodable body --
    stops the scan::

        {"n_records": int, "end_offset": bytes consumed cleanly,
         "wal_bytes": file size, "truncated": bool,
         "bad_frame_at": offset | None, "bad_frame_reason": str | None}
    """
    size = os.path.getsize(path)
    records: List[WalRecord] = []
    report = {"n_records": 0, "end_offset": start, "wal_bytes": size,
              "truncated": False, "bad_frame_at": None,
              "bad_frame_reason": None}

    def _bad(off: int, reason: str):
        report["truncated"] = True
        report["bad_frame_at"] = off
        report["bad_frame_reason"] = reason

    with open(path, "rb") as f:
        f.seek(start)
        off = start
        while True:
            header = f.read(_HEADER.size)
            if not header:
                break                      # clean end
            if len(header) < _HEADER.size:
                _bad(off, f"short header ({len(header)}B of "
                          f"{_HEADER.size}B)")
                break
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length:
                _bad(off, f"truncated payload ({len(payload)}B of "
                          f"{length}B)")
                break
            if zlib.crc32(payload) != crc:
                _bad(off, "crc mismatch")
                break
            try:
                records.append(decode_payload(payload))
            except ValueError as e:
                _bad(off, f"undecodable payload: {e}")
                break
            off += _HEADER.size + length
            report["n_records"] += 1
            report["end_offset"] = off
    return records, report


def read_last_lifecycle(path: str) -> Optional[str]:
    """The last LIFECYCLE record's state (None if the log has none or does
    not exist)."""
    if not os.path.exists(path):
        return None
    records, _ = read_wal(path)
    state = None
    for rec in records:
        if rec.op == OP_LIFECYCLE:
            state = rec.value.get("state")
    return state


def read_spec(path: str) -> Optional[dict]:
    """The first REGISTER record's spec dict (None if absent): what
    recovery without a snapshot rebuilds the tenant from."""
    records, _ = read_wal(path)
    for rec in records:
        if rec.op == OP_REGISTER:
            return rec.value
    return None
