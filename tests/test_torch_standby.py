"""The port's warm standby, and kill -9 in a compaction, on the CPU.

Mirrors ``tests/test_standby.py`` and the kill -9 compaction cases of
``tests/test_maintenance.py`` for ``repro_torch``:

* while tailing, the standby's registry answers **bit-identically** (ids
  and distance bits) to the live primary over the durable prefix;
* a torn tail (the primary mid-append) is retried, never fatal;
* tenants whose log ends in an "unloaded" LIFECYCLE record are skipped,
  as ``recover`` skips them, also when the unload lands after adoption;
* the tailer thread is joined with a timeout and found dead;
* after a real ``kill -9`` of the primary, promotion serves the bits of an
  uninterrupted reference, and the promoted registry owns the logs;
* a ``kill -9`` at ``compact.freeze`` #2 or ``compact.swap`` #2 recovers
  to the bits of a fresh index fed the durable prefix, and a second replay
  changes nothing.

Subprocesses import only numpy, torch and ``repro_torch``, run with
``device="cpu"``, inherit no ``REPRO_*`` variable and have a 120 s timeout
each.  The JAX package's 8-device (``mesh8``) promotion waits for the
port's multi-device serving.
"""

import os
import signal
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import (ServableRegistry, ServableSpec,  # noqa: E402
                               WalStandby, faults, wal)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DIMS = 16
TIMEOUT_S = 120


def _spec(name="t", p=2.0, emb="basis", **kw):
    return ServableSpec(name=name, n_dims=N_DIMS, p=p, r=2.0, embedder=emb,
                        log2_buckets=8, bucket_capacity=64,
                        segment_capacity=64, insert_chunk=32,
                        chunk_sizes=(8, 32), **kw)


def _data(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _answer(index, q):
    g, d = index.query(q, 10, n_probes=4)
    return g.numpy(), d.numpy().view(np.uint32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _primary(wal_dir, names=("t",), **kw):
    reg = ServableRegistry(device="cpu", wal_dir=wal_dir, fsync_every=1)
    for name in names:
        reg.register(_spec(name, **kw))
    return reg


def _unload(reg, name):
    """What the front end's unload writes: a synced LIFECYCLE record."""
    w = reg.get(name).index.wal
    w.append(wal.encode_lifecycle("unloaded"))
    w.sync()


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_standby_tails_and_promotes_bit_identical(tmp_path, precision):
    wal_dir = str(tmp_path / "wal")
    prim = _primary(wal_dir, precision=precision)
    sb = WalStandby(wal_dir, device="cpu")
    q = _data(9, seed=9, scale=0.9)
    sv = prim.get("t")
    for seed in (1, 2, 3):
        g = sv.insert(_data(40, seed=seed))
        sv.delete(g[::6])
        if seed == 2:
            sv.maintenance.compact()
        if seed == 3:
            sv.index.maintenance.seal()
        out = sb.poll_once()
        assert out["t"]["lag_bytes"] == 0
        _assert_bits(_answer(sb.registry.get("t").index, q),
                     _answer(sv.index, q))
    assert sb.registry.get("t").spec.precision == precision

    # lag is visible mid-stream: durable bytes not replayed yet
    sv.insert(_data(20, seed=4))
    assert sb.lag()["t"] > 0
    sb.poll_once()
    assert sb.lag()["t"] == 0

    reports = sb.promote()
    assert reports["t"]["applied"] == 0          # nothing left to replay
    assert sb.promote() == {}                    # idempotent
    assert sb.poll_once() == {}

    # the promoted registry owns the log: new writes append and recover
    psv = sb.registry.get("t")
    _assert_bits(_answer(psv.index, q), _answer(sv.index, q))
    psv.index.insert(_data(15, seed=5))
    reg3 = ServableRegistry(device="cpu")
    reg3.recover(wal_dir=wal_dir)
    _assert_bits(_answer(reg3.get("t").index, q), _answer(psv.index, q))


def test_standby_torn_tail_retries(tmp_path):
    wal_dir = str(tmp_path / "wal")
    sv = _primary(wal_dir).get("t")
    sv.insert(_data(30, seed=1))
    sb = WalStandby(wal_dir, device="cpu")
    sb.poll_once()

    # the primary mid-append: a torn frame at the tail
    path = os.path.join(wal_dir, "t.wal")
    with open(path, "ab") as f:
        f.write(struct.pack("<I", 1000) + b"\x00" * 7)
    out = sb.poll_once()                         # stops before the tear
    assert out["t"]["applied"] == 0
    assert out["t"]["lag_bytes"] == 11

    # more bytes land: the tear is replaced by a real append, and the
    # cursor picks up where it stopped
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 11)
    sv.insert(_data(10, seed=2))
    out = sb.poll_once()
    assert out["t"]["applied"] == 1 and out["t"]["lag_bytes"] == 0
    q = _data(5, seed=9, scale=0.9)
    _assert_bits(_answer(sb.registry.get("t").index, q),
                 _answer(sv.index, q))


def test_standby_promote_truncates_a_torn_tail(tmp_path):
    wal_dir = str(tmp_path / "wal")
    sv = _primary(wal_dir).get("t")
    sv.insert(_data(30, seed=1))
    path = os.path.join(wal_dir, "t.wal")
    clean = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(struct.pack("<I", 1000) + b"\x00" * 7)
    sb = WalStandby(wal_dir, device="cpu")
    rep = sb.promote()["t"]
    assert rep["truncated"] and rep["truncated_to"] == clean
    assert os.path.getsize(path) == clean
    assert rep["applied"] == 2                   # REGISTER + INSERT
    sb.registry.get("t").insert(_data(5, seed=2))
    assert not wal.read_wal(path)[1]["truncated"]


def test_standby_skips_unloaded_tenants(tmp_path):
    wal_dir = str(tmp_path / "wal")
    prim = _primary(wal_dir, names=("keep", "gone", "late"))
    for name in ("keep", "gone", "late"):
        prim.get(name).insert(_data(30, seed=1))
    _unload(prim, "gone")                # before the standby sees it

    sb = WalStandby(wal_dir, device="cpu")
    out = sb.poll_once()
    assert sorted(out) == ["keep", "late"]
    assert sb.registry.names() == ["keep", "late"]

    # "late" unloads after adoption: a no-op record while tailing, then
    # promotion drops it
    _unload(prim, "late")
    sb.poll_once()
    reports = sb.promote()
    assert reports["late"] == {"skipped": "unloaded"}
    assert sb.registry.names() == ["keep"]


def test_standby_tailer_thread_runs_and_stops(tmp_path):
    wal_dir = str(tmp_path / "wal")
    prim = _primary(wal_dir)
    sb = WalStandby(wal_dir, device="cpu", poll_interval_s=0.01)
    sb.start()
    thread = sb._thread
    try:
        assert sb.running
        prim.get("t").insert(_data(25, seed=1))
        caught_up = threading.Event()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if sb.lag().get("t") == 0 and "t" in sb.registry.names() and \
                    sb.registry.get("t").index.n_live == 25:
                caught_up.set()
                break
            caught_up.wait(0.01)
        assert caught_up.is_set()
    finally:
        t0 = time.monotonic()
        sb.stop()
        stop_s = time.monotonic() - t0
    assert not thread.is_alive() and not sb.running
    assert stop_s < 5.0          # the event wakes it: no poll interval lost
    assert sb.registry.get("t").index.n_live == 25


def test_promote_drains_after_a_poll_in_progress(tmp_path):
    """promote() drains under the standby's lock: records a poll still
    holding the lock applies are not applied again (a SEAL applied twice
    would seal a second segment)."""
    wal_dir = str(tmp_path / "wal")
    prim = _primary(wal_dir)
    sb = WalStandby(wal_dir, device="cpu")
    prim.get("t").insert(_data(25, seed=1))
    sb.poll_once()
    prim.get("t").insert(_data(10, seed=2))
    prim.get("t").index.maintenance.seal()
    reports = {}
    promoter = threading.Thread(target=lambda: reports.update(sb.promote()))
    with sb._lock:                 # the poll in progress
        promoter.start()
        fol = sb._followers["t"]
        records, _ = fol.poll()
        assert [r.op for r in records] == [wal.OP_INSERT, wal.OP_SEAL]
        sb.registry.get("t").index.apply_records(records)
    promoter.join(timeout=30.0)
    assert not promoter.is_alive()
    assert reports["t"]["applied"] == 0
    want, got = prim.get("t").index, sb.registry.get("t").index
    assert [s.n_items for s in got.segments] == \
        [s.n_items for s in want.segments]
    q = _data(9, seed=3)
    _assert_bits(_answer(got, q), _answer(want, q))


def test_standby_adopts_the_recorded_tier(tmp_path, monkeypatch):
    """A spec adopted from a REGISTER record keeps its resolved tier, even
    with ``$REPRO_STORE_DTYPE`` set in the standby's process."""
    wal_dir = str(tmp_path / "wal")
    _primary(wal_dir, precision="int8").get("t").insert(_data(70, seed=1))
    monkeypatch.setenv("REPRO_STORE_DTYPE", "bf16")
    sb = WalStandby(wal_dir, device="cpu")
    sb.poll_once()
    assert sb.registry.get("t").index.precision == "int8"
    assert sb.registry.get("t").index.n_live == 70


# ---------------------------------------------------------------------------
# kill -9: the standby's primary, and mid-compaction
# ---------------------------------------------------------------------------


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def _run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=_env(), cwd=ROOT)


_COMMON = """
    import os
    import sys
    import numpy as np
    from repro_torch.serve import ServableRegistry, ServableSpec, faults
    from repro_torch.serve.registry import _spec_from_manifest
    from repro_torch.serve.wal import read_spec

    assert "jax" not in sys.modules

    def spec():
        return ServableSpec(
            name="t", n_dims=16, p=2.0, r=2.0, embedder="basis",
            log2_buckets=8, bucket_capacity=64, segment_capacity=64,
            insert_chunk=32, chunk_sizes=(8, 32))

    def queries():
        return (np.random.default_rng(1).normal(size=(9, 16)) *
                0.9).astype(np.float32)

    def answer(index, qs):
        g, d = index.query(qs, 10, n_probes=4)
        return g.numpy(), d.numpy().view(np.uint32)

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def reference(wal_dir):
        # the uninterrupted run over the durable prefix
        wpath = os.path.join(wal_dir, "t.wal")
        sv = ServableRegistry(device="cpu").register(
            _spec_from_manifest(read_spec(wpath)))
        sv.index.replay(wpath)
        return sv.index
"""

_STANDBY_CRASH = _COMMON + """
    faults.install(faults.FaultPlan(
        faults.FaultSpec("wal.appended", nth={nth}, action="kill")))
    reg = ServableRegistry(device="cpu", wal_dir={wal!r}, fsync_every=1)
    sv = reg.register(spec())
    rng = np.random.default_rng(0)
    for step in range(10):
        g = sv.insert(rng.normal(size=(25, 16)).astype(np.float32))
        if step % 2 == 1:
            sv.delete(g[:5])
        if step % 4 == 3:
            sv.maintenance.compact()
    print("SURVIVED")
    sys.exit(3)
"""

_PROMOTE = _COMMON + """
    from repro_torch.serve import WalStandby

    WAL = {wal!r}
    sb = WalStandby(WAL, device="cpu")
    sb.poll_once()                 # warm: replay while the primary is down
    reports = sb.promote()
    assert "t" in reports, reports
    qs = queries()
    want = answer(reference(WAL), qs)
    assert same(answer(sb.registry.get("t").index, qs), want)

    # the promoted registry keeps logging: a fresh recovery over the same
    # directory sees the writes made after the failover
    sb.registry.get("t").index.insert(
        np.random.default_rng(7).normal(size=(10, 16)).astype(np.float32))
    reg2 = ServableRegistry(device="cpu")
    reg2.recover(wal_dir=WAL)
    assert same(answer(reg2.get("t").index, qs),
                answer(sb.registry.get("t").index, qs))
    print("PROMOTE_OK", reports["t"]["applied"])
"""

_COMPACT_CRASH = _COMMON + """
    faults.install(faults.FaultPlan(
        faults.FaultSpec({site!r}, nth={nth}, action="kill")))
    reg = ServableRegistry(device="cpu", wal_dir={wal!r}, fsync_every=1)
    sv = reg.register(spec())
    rng = np.random.default_rng(0)
    for step in range(8):
        g = sv.insert(rng.normal(size=(30, 16)).astype(np.float32))
        if step % 2 == 1:
            sv.delete(g[:6])
        if step % 3 == 2:
            sv.maintenance.compact()   # fires compact.freeze / .swap
    print("SURVIVED")
    sys.exit(3)
"""

_COMPACT_RECOVER = _COMMON + """
    WAL = {wal!r}
    reg = ServableRegistry(device="cpu")
    reports = reg.recover(wal_dir=WAL)
    assert sorted(reports) == ["t"], reports
    qs = queries()
    want = answer(reference(WAL), qs)
    assert same(answer(reg.get("t").index, qs), want)
    # a second replay: every insert drops, the replayed COMPACT re-runs on
    # the compacted structure, and no bit changes
    rep2 = reg.get("t").index.replay(os.path.join(WAL, "t.wal"))
    assert rep2["dropped_duplicates"] > 0, rep2
    assert same(answer(reg.get("t").index, qs), want)
    print("PARITY_OK")
"""


def _killed(proc, what):
    assert proc.returncode == -signal.SIGKILL, (
        f"expected SIGKILL at {what}, got rc={proc.returncode}\n"
        f"stdout: {proc.stdout[-1500:]}\nstderr: {proc.stderr[-1500:]}")
    assert "SURVIVED" not in proc.stdout


def _ok(proc, token, what):
    assert proc.returncode == 0, (
        f"{what} failed\nstdout: {proc.stdout[-1500:]}\n"
        f"stderr: {proc.stderr[-3000:]}")
    assert token in proc.stdout


def test_kill9_primary_standby_promotes_bit_identical(tmp_path):
    wal_dir = str(tmp_path / "wal")
    _killed(_run(_STANDBY_CRASH.format(wal=wal_dir, nth=12)),
            "wal.appended#12")
    _ok(_run(_PROMOTE.format(wal=wal_dir)), "PROMOTE_OK", "promotion")


@pytest.mark.parametrize("site,nth",
                         [("compact.freeze", 2), ("compact.swap", 2)],
                         ids=["freeze", "swap"])
def test_kill9_mid_compaction_replays_bit_identical(tmp_path, site, nth):
    """SIGKILL inside a compaction: whether the COMPACT record is durable
    decides it, and recovery replays the durable prefix to the bits of a
    fresh index fed that prefix."""
    wal_dir = str(tmp_path / "wal")
    _killed(_run(_COMPACT_CRASH.format(site=site, nth=nth, wal=wal_dir)),
            f"{site}#{nth}")
    _ok(_run(_COMPACT_RECOVER.format(wal=wal_dir)), "PARITY_OK",
        f"recovery after {site}#{nth}")
    ops = [r.op_name for r in wal.read_wal(
        os.path.join(wal_dir, "t.wal"))[0]]
    assert ops.count("compact") == 2          # the second one was framed


def test_launcher_standby_promotes_on_sigterm(tmp_path):
    """``launch.serve --standby WAL_DIR`` tails until SIGTERM, then
    promotes and reports; the promoted tenant holds the primary's items."""
    import select
    wal_dir = str(tmp_path / "wal")
    _primary(wal_dir).get("t").insert(_data(40, seed=1))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--standby", wal_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
    try:
        first = ""
        deadline = time.monotonic() + TIMEOUT_S
        while "tailing" not in first and time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                first = proc.stdout.readline()
                if not first:
                    break                     # the process ended
        assert "[serve] standby tailing" in first, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    assert "[serve] promoted t: applied=" in out
    assert "[serve] standby promoted: tenants ['t']" in out
    assert "[serve] OK" in out
