"""kill -9 crash and recovery of the port, on the CPU.

Mirrors ``tests/test_crash_recovery.py`` for ``repro_torch``.  Each case
runs a fixed two-tenant workload (p = 2 basis + p = 1 qmc) in a **crash
subprocess** whose ``FaultPlan`` SIGKILLs it at one write-path event, at
the JAX tests' sites and counts: mid-WAL-append (``wal.append`` #9, a torn
frame on disk), before and after the group-commit fsync (``wal.fsync`` /
``wal.fsynced`` #4), mid-snapshot-rename (``ckpt.rename`` #2: one tenant
snapshotted, the other not) and mid-seal (``seal`` #2: SEAL framed, not
applied).  The parent checks that the child died of SIGKILL, then runs a
**recovery subprocess** that

* recovers with ``ServableRegistry.recover`` (the newest verifiable
  snapshot + a replay of the WAL tail);
* rebuilds a *reference* registry by replaying each tenant's whole
  durable WAL prefix into a fresh index -- the uninterrupted run over the
  durable operations, wherever the kill landed;
* requires the answers to be **bit-identical** (ids and distance bits);
* replays the WAL a second time into the recovered index and requires the
  duplicates to drop with the answers unchanged.

Subprocesses import only numpy, torch and ``repro_torch`` (never jax), run
with ``device="cpu"``, inherit no ``REPRO_*`` variable and have a 120 s
timeout each.  The JAX package's sharded-serving kill case waits for the
port's multi-device serving.  The compaction and standby kills are in
``tests/test_torch_standby.py``.
"""

import os
import signal
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def _run(code: str):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=_env(), cwd=ROOT)


# The workload both subprocesses agree on: 12 steps of insert / delete /
# explicit-seal churn across two tenants, one snapshot midway.
_WORKLOAD = """
    import sys
    import numpy as np
    from repro_torch.serve import ServableRegistry, ServableSpec

    assert "jax" not in sys.modules

    def build_registry(wal_dir, fsync_every=2):
        reg = ServableRegistry(device="cpu", wal_dir=wal_dir,
                               fsync_every=fsync_every)
        for name, p, emb in (("p2", 2.0, "basis"), ("p1", 1.0, "qmc")):
            reg.register(ServableSpec(
                name=name, n_dims=16, p=p, r=2.0, embedder=emb,
                log2_buckets=8, bucket_capacity=64, segment_capacity=64,
                insert_chunk=32, chunk_sizes=(8, 32)))
        return reg

    def run_workload(reg, ckpt_dir):
        rng = np.random.default_rng(0)
        for step in range(12):
            for name in ("p2", "p1"):
                sv = reg.get(name)
                g = sv.insert(rng.normal(size=(20, 16)).astype(np.float32))
                if step % 3 == 2:
                    sv.delete(g[:5])
                if step % 4 == 3:
                    sv.index.maintenance.seal()
            if step == 5:
                reg.snapshot(ckpt_dir, step=1)

    def queries():
        return (np.random.default_rng(1).normal(size=(9, 16)) *
                0.9).astype(np.float32)

    def answer(index, qs):
        g, d = index.query(qs, 10, n_probes=4)
        return g.numpy(), d.numpy().view(np.uint32)
"""

_CRASH = _WORKLOAD + """
    from repro_torch.serve import faults

    faults.install(faults.FaultPlan(
        faults.FaultSpec({site!r}, nth={nth}, action="kill")))
    reg = build_registry({wal!r})
    run_workload(reg, {ckpt!r})
    print("SURVIVED")          # reached only if the fault never fired
    sys.exit(3)
"""

_RECOVER = _WORKLOAD + """
    import os
    from repro_torch.serve.registry import _spec_from_manifest
    from repro_torch.serve.wal import read_spec

    WAL, CKPT = {wal!r}, {ckpt!r}
    reg = ServableRegistry(device="cpu")
    reports = reg.recover(ckpt_root=CKPT, wal_dir=WAL)
    assert sorted(reports) == ["p1", "p2"], reports

    # reference: the uninterrupted run over the durable operations, a
    # fresh index fed the whole verifiable WAL prefix
    ref = ServableRegistry(device="cpu")
    for name in ("p1", "p2"):
        wpath = os.path.join(WAL, name + ".wal")
        ref.register(_spec_from_manifest(read_spec(wpath))).index.replay(
            wpath)

    qs = queries()
    for name in ("p1", "p2"):
        want = answer(ref.get(name).index, qs)
        got = answer(reg.get(name).index, qs)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), name
        assert (want[0] >= 0).any(), name
        # a second replay drops every insert and changes no bit
        rep2 = reg.get(name).index.replay(os.path.join(WAL, name + ".wal"))
        assert rep2["dropped_duplicates"] > 0, rep2
        got = answer(reg.get(name).index, qs)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), name
    assert "jax" not in sys.modules
    print("PARITY_OK", {{n: (reports[n].get("restored_step"),
                             reports[n].get("applied"),
                             reports[n].get("truncated"))
                         for n in sorted(reports)}})
"""


def _crash_then_recover(tmp_path, site, nth):
    wal_dir, ckpt_dir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    crash = _run(_CRASH.format(site=site, nth=nth, wal=wal_dir,
                               ckpt=ckpt_dir))
    assert crash.returncode == -signal.SIGKILL, (
        f"expected SIGKILL at {site}#{nth}, got rc={crash.returncode}\n"
        f"stdout: {crash.stdout[-1500:]}\nstderr: {crash.stderr[-1500:]}")
    assert "SURVIVED" not in crash.stdout
    rec = _run(_RECOVER.format(wal=wal_dir, ckpt=ckpt_dir))
    assert rec.returncode == 0, (
        f"recovery after {site}#{nth} failed\n"
        f"stdout: {rec.stdout[-1500:]}\nstderr: {rec.stderr[-3000:]}")
    assert "PARITY_OK" in rec.stdout
    return rec.stdout


_SITES = [("wal.append", 9), ("wal.fsync", 4), ("wal.fsynced", 4),
          ("ckpt.rename", 2), ("seal", 2)]


@pytest.mark.parametrize("site,nth", _SITES, ids=[s for s, _ in _SITES])
def test_kill9_recovery_bit_identical(tmp_path, site, nth):
    out = _crash_then_recover(tmp_path, site, nth)
    if site == "ckpt.rename":
        # the kill hit the second tenant's rename: p2's snapshot is on
        # disk, p1 recovers from its WAL alone
        assert "'p1': (None" in out and "'p2': (1" in out
