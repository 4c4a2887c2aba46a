"""The port's wire protocol and client helpers against the JAX package's.

``repro_torch.serve.protocol`` and ``.client`` are the port's own copies
of ``repro/serve/protocol.py`` and ``client.py``.  Over one corpus of
frames (every op, every malformed field, NaN and +-inf values, frames
over ``MAX_FRAME_BYTES``) both packages must give equal bytes from
``encode``, equal objects (or the same error type) from ``decode_line``
and equal results from ``validate_request``; ``FrameDecoder`` must split
any fragmentation of a byte stream into the same frames (hypothesis).
The one deliberate difference: the port's ``MAINTENANCE_KINDS`` is its
``serve.maintenance.KINDS`` (``seal``, ``compact``), so a
``set_replication`` frame, valid in the JAX package, is ``bad_request``
in the port until multi-device serving arrives.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from _hypothesis_support import given, settings, st  # noqa: E402

from repro.serve import client as jclient  # noqa: E402
from repro.serve import protocol as jproto  # noqa: E402
from repro_torch.serve import client as tclient  # noqa: E402
from repro_torch.serve import maintenance as tmaint  # noqa: E402
from repro_torch.serve import protocol as tproto  # noqa: E402

ROW = [0.5, -1.25, 3.0]


def _corpus():
    """(name, frame dict) pairs: one well-formed frame per op, then every
    malformed field ``validate_request`` checks, then odd values."""
    ok = [
        {"id": 1, "op": "query", "tenant": "t", "queries": [ROW], "k": 3},
        {"id": 2, "op": "query", "tenant": "t", "queries": [ROW, ROW],
         "k": 1, "n_probes": 4, "timeout_ms": 50.0},
        {"id": 3, "op": "insert", "tenant": "t", "embeddings": [ROW]},
        {"id": 4, "op": "insert", "tenant": "t", "embeddings": [ROW],
         "gids": [7]},
        {"id": 5, "op": "delete", "tenant": "t", "gids": [1, 2]},
        {"id": 6, "op": "embed", "tenant": "t", "fvals": [ROW]},
        {"id": 7, "op": "maintenance", "tenant": "t", "kind": "seal"},
        {"id": 8, "op": "maintenance", "tenant": "t", "kind": "compact",
         "params": {}},
        {"id": 9, "op": "job_status", "job_id": "mj-1"},
        {"id": 10, "op": "load", "spec": {"name": "x"}},
        {"id": "s", "op": "unload", "tenant": "t"},
        {"op": "update", "spec": {"name": "x", "max_delay_ms": 1.0}},
        {"id": 12, "op": "health"},
        {"id": 13, "op": "stats"},
        {"id": 14, "op": "stats", "tenant": "t"},
    ]
    bad = [
        {"id": 20, "op": "nope"},
        {"id": 21},
        {"id": [1], "op": "health"},
        {"id": 1.5, "op": "health"},
        {"id": 22, "op": "query", "queries": [ROW], "k": 3},
        {"id": 23, "op": "query", "tenant": 5, "queries": [ROW], "k": 3},
        {"id": 24, "op": "query", "tenant": "t", "queries": [], "k": 3},
        {"id": 25, "op": "query", "tenant": "t", "queries": "x", "k": 3},
        {"id": 26, "op": "query", "tenant": "t", "queries": [ROW], "k": 0},
        {"id": 27, "op": "query", "tenant": "t", "queries": [ROW],
         "k": 2.0},
        {"id": 28, "op": "query", "tenant": "t", "queries": [ROW]},
        {"id": 29, "op": "insert", "tenant": "t"},
        {"id": 30, "op": "insert", "tenant": "t", "embeddings": {"a": 1}},
        {"id": 31, "op": "delete", "tenant": "t", "gids": 3},
        {"id": 32, "op": "embed", "tenant": "t"},
        {"id": 33, "op": "embed", "fvals": [ROW]},
        {"id": 34, "op": "unload"},
        {"id": 35, "op": "job_status", "job_id": 3},
        {"id": 36, "op": "job_status"},
        {"id": 37, "op": "load"},
        {"id": 38, "op": "load", "spec": ["name"]},
        {"id": 39, "op": "update", "spec": "x"},
        {"id": 40, "op": "maintenance", "tenant": "t", "kind": "seal",
         "params": [1]},
        {"id": 41, "op": "maintenance", "tenant": "t"},
        {"id": 42, "op": "maintenance", "kind": "compact"},
    ]
    odd = [
        {"id": 50, "op": "query", "tenant": "t",
         "queries": [[float("nan"), float("inf"), -float("inf")]], "k": 2},
        {"id": 51, "op": "insert", "tenant": "t",
         "embeddings": [[1e-45, 3.4028234663852886e38, -0.0]]},
        {"id": 52, "op": "query", "tenant": "tenant with spaces é",
         "queries": [ROW], "k": 2, "extra": {"nested": [None, True]}},
    ]
    return ([(f"ok{i}", m) for i, m in enumerate(ok)]
            + [(f"bad{i}", m) for i, m in enumerate(bad)]
            + [(f"odd{i}", m) for i, m in enumerate(odd)])


CORPUS = _corpus()


def test_constants_equal_the_jax_package():
    assert tproto.CODES == jproto.CODES
    assert tproto.OPS == jproto.OPS
    assert tproto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES
    # the port's kinds are its pool's, and the JAX package's three
    assert tproto.MAINTENANCE_KINDS == tmaint.KINDS == \
        jproto.MAINTENANCE_KINDS == ("seal", "compact", "set_replication")


@pytest.mark.parametrize("name,msg", CORPUS, ids=[n for n, _ in CORPUS])
def test_encode_decode_validate_equal(name, msg):
    frame = tproto.encode(msg)
    assert frame == jproto.encode(msg)
    assert frame.endswith(b"\n") and frame.count(b"\n") == 1
    # decoded frames compared through encode: NaN != NaN as a value
    assert tproto.encode(tproto.decode_line(frame)) == \
        jproto.encode(jproto.decode_line(frame)) == frame
    want = jproto.validate_request(msg)
    if want is not None:             # a message that names the kinds
        want = want.replace(repr(jproto.MAINTENANCE_KINDS),
                            repr(tproto.MAINTENANCE_KINDS))
    assert tproto.validate_request(msg) == want


@pytest.mark.parametrize("kind", ["set_replication", "bogus", None])
def test_maintenance_kind_outside_the_port(kind):
    """``set_replication`` is a kind of the port's as of the JAX
    package's; an unknown or missing kind is refused by both, with the same
    message."""
    msg = {"id": 1, "op": "maintenance", "tenant": "t", "kind": kind}
    err = tproto.validate_request(msg)
    assert err == jproto.validate_request(msg)
    assert (err is None) == (kind == "set_replication")
    if err is not None:
        assert "('seal', 'compact', 'set_replication')" in err


@pytest.mark.parametrize("line", [
    b"[1, 2]\n", b"\"s\"\n", b"3\n", b"null\n", b"{\"a\": \n",
    b"\xff\xfe\n", b"", b"{}\n", b"{\"op\": \"health\"}"],
    ids=["list", "str", "int", "null", "torn", "not-utf8", "empty",
         "empty-object", "no-newline"])
def test_decode_line_errors_equal(line):
    def outcome(proto):
        try:
            return ("ok", proto.encode(proto.decode_line(line)))
        except Exception as e:      # noqa: BLE001 -- compared by type
            return ("raise", type(e))
    assert outcome(tproto) == outcome(jproto)


def test_frame_size_cap_equal(monkeypatch):
    for proto in (tproto, jproto):
        monkeypatch.setattr(proto, "MAX_FRAME_BYTES", 64)
    big = jproto.encode({"id": 1, "op": "stats", "tenant": "x" * 80})
    for proto in (tproto, jproto):
        with pytest.raises(ValueError, match="MAX_FRAME_BYTES"):
            proto.decode_line(big)
        dec = proto.FrameDecoder()
        with pytest.raises(ValueError, match="MAX_FRAME_BYTES"):
            list(dec.feed(b"x" * 65))


def test_error_and_ok_frames_equal():
    for args in [(1, "overloaded", "full", 25.0), (None, "bad_request", "x"),
                 ("a", "queue_full", "q", 1.23456)]:
        assert tproto.error(*args) == jproto.error(*args)
    for proto in (tproto, jproto):
        with pytest.raises(ValueError, match="unknown error code"):
            proto.error(1, "nope", "x")
    assert tproto.ok(3, gids=[[1]]) == jproto.ok(3, gids=[[1]])


_FRAMES = st.lists(
    st.fixed_dictionaries({
        "id": st.integers(0, 10 ** 6),
        "op": st.sampled_from(jproto.OPS),
        "x": st.lists(st.floats(allow_nan=False, width=32), max_size=6),
        "s": st.text(max_size=8)}),
    min_size=1, max_size=8)


@settings(max_examples=60, deadline=None)
@given(frames=_FRAMES, cuts=st.lists(st.integers(0, 4000), max_size=12),
       blank=st.booleans())
def test_frame_decoder_over_random_splits(frames, cuts, blank):
    stream = b"".join(jproto.encode(f) + (b"\n" if blank else b"")
                      for f in frames)
    pos = sorted({min(c, len(stream)) for c in cuts} | {0, len(stream)})
    pieces = [stream[a:b] for a, b in zip(pos, pos[1:])]
    got = {}
    for name, proto in (("port", tproto), ("jax", jproto)):
        dec = proto.FrameDecoder()
        out = []
        for piece in pieces:
            out += [proto.encode(m) for m in dec.feed(piece)]
        got[name] = out
    assert got["port"] == got["jax"] == [jproto.encode(f) for f in frames]


def test_retry_policy_schedule_equal():
    for kw in [{}, {"base_ms": 3.0, "cap_ms": 40.0},
               {"max_attempts": 2, "retryable": ("overloaded",)}]:
        tp, jp = tclient.RetryPolicy(**kw), jclient.RetryPolicy(**kw)
        assert tp == tclient.RetryPolicy(**kw)
        for attempt in range(8):
            for hint in (None, 0, 5.0, 700.0, 5000.0):
                assert tp.backoff_ms(attempt, hint) == \
                    jp.backoff_ms(attempt, hint)


@pytest.mark.parametrize("script", [
    ["ok"], ["overloaded", "queue_full", "ok"],
    ["overloaded"] * 7, ["queue_full", "shutting_down", "ok"],
    ["draining", "ok"]])
def test_request_with_retries_equal(script):
    def run(module):
        seq, sleeps = iter(script), []

        def send():
            code = next(seq, "ok")
            if code == "ok":
                return {"id": 1, "ok": True}
            return {"id": 1, "ok": False, "code": code,
                    "retry_after_ms": 25.0}
        resp, n = module.request_with_retries(
            send, module.RetryPolicy(), sleep=sleeps.append)
        return resp, n, sleeps
    assert run(tclient) == run(jclient)


def test_frontend_error_fields_equal():
    resp = {"id": 1, "ok": False, "code": "queue_full", "error": "q",
            "retry_after_ms": 25.0}
    te, je = tclient.FrontendError(resp), jclient.FrontendError(resp)
    assert (str(te), te.code, te.retry_after_ms, te.response) == \
        (str(je), je.code, je.retry_after_ms, je.response)


def test_client_request_frames_equal():
    """The bytes each client writes for the same calls (a socket pair
    stands in for the server)."""
    import socket

    def frames(module):
        a, b = socket.socketpair()
        try:
            c = module.FrontendClient.__new__(module.FrontendClient)
            c._sock, c._f = a, a.makefile("rwb")
            import itertools
            import threading
            c._ids, c._lock = itertools.count(1), threading.Lock()
            rows = np.array([[0.1, -2.5], [np.nan, np.inf]], np.float32)
            calls = [("query", ("t", rows, 3), {"n_probes": 2,
                                                "timeout_ms": 9}),
                     ("insert", ("t", rows[:1]), {"gids": [4]}),
                     ("delete", ("t", [1, 2]), {}),
                     ("embed", ("t", rows.astype(np.float64)), {}),
                     ("maintenance", ("t", "compact"), {}),
                     ("job_status", ("mj-1",), {}),
                     ("health", (), {}), ("stats", ("t",), {})]
            out = []
            for op, args, kw in calls:
                b.sendall(jproto.encode({"id": len(out) + 1, "ok": True,
                                         "gids": [[0]], "n_deleted": 0,
                                         "embeddings": [[0.0]],
                                         "job_id": "mj-1"}))
                getattr(c, op)(*args, **kw)
                out.append(b.recv(1 << 16))
            return out
        finally:
            a.close()
            b.close()
    got, want = frames(tclient), frames(jclient)
    assert got == want
    assert json.loads(got[0].replace(b"NaN", b"null"))["op"] == "query"
