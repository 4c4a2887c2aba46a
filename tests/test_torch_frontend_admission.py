"""The port's front-end admission gate, batcher pump and tenant lifecycle.

Mirrors ``tests/test_frontend_admission.py`` for ``repro_torch`` (every
backpressure edge pinned with a simulated clock, each with its counter in
a private ``MetricsRegistry``; the wall-clock pump thread bit-equal to the
injected-clock path; ``_wait_s``; LIFECYCLE records and ``recover``
skipping a cleanly unloaded tenant), and holds the port to the JAX
package:

* one scripted event sequence (sim clock: admit, settle, ``set_state``,
  ``begin_drain``, deadlines) through both packages' ``RequestGate`` gives
  equal outcomes, responses, totals and metric series;
* the same register / insert / ``log_lifecycle`` / ``unregister`` sequence
  writes byte-equal WAL files in both packages, and both packages'
  ``recover`` skip the unloaded tenant of the port's logs.

Threads are stopped in a ``finally`` and joined with a timeout; metrics
are read from private registries or as deltas under tenant names unique
to this file.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import (MicroBatcher, ServableRegistry,  # noqa: E402
                               ServableSpec)
from repro_torch.serve import frontend as tfe  # noqa: E402
from repro_torch.serve import wal as walmod  # noqa: E402
from repro_torch.serve.frontend import (DRAINING, LOADING, READY,  # noqa
                                        Rejection, RequestGate)

N_DIMS = 8
JOIN_S = 30.0


class SimClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _gate(clock, **kw):
    kw.setdefault("max_inflight", 2)
    kw.setdefault("queue_depth", 4)
    reg = obs_metrics.MetricsRegistry()
    return RequestGate(clock=clock, metrics=reg, **kw), reg


def _rejects(reg, tenant, reason):
    return reg.value("frontend_rejects_total", tenant=tenant,
                     reason=reason) or 0.0


def _pure_qfn(k=3):
    """Answers that depend only on a row's values, never on its place in
    the padded chunk: packing the same requests into other chunks must
    give the same per-request answers."""

    def qfn(buf, kk, n_probes):
        base = np.asarray(np.floor(buf[:, :1] * 1e3), np.int32)
        ids = base + np.arange(kk, dtype=np.int32)
        return ids, ids.astype(np.float32) * 0.25

    return qfn


def _stop(b):
    b.stop(timeout_s=JOIN_S)
    assert b._thread is None


# -- RequestGate backpressure edges -----------------------------------------


def test_quota_exhaustion_rejects_then_settle_frees_slot():
    clk = SimClock()
    g, reg = _gate(clk, max_inflight=2)
    g.set_state("t", READY)
    a = g.admit("t")
    b = g.admit("t")
    assert not isinstance(a, Rejection) and not isinstance(b, Rejection)
    r = g.admit("t")
    assert isinstance(r, Rejection)
    assert r.code == "overloaded"
    assert r.retry_after_ms == 25.0
    assert _rejects(reg, "t", "overloaded") == 1.0
    assert g.inflight("t") == 2
    assert g.settle(a) == "ok"
    assert g.inflight("t") == 1
    assert not isinstance(g.admit("t"), Rejection)
    assert reg.value("frontend_inflight", tenant="t") == 2.0


def test_queue_depth_cap_rejects():
    clk = SimClock()
    g, reg = _gate(clk, queue_depth=4)
    g.set_state("t", READY)
    assert not isinstance(g.admit("t", queue_depth=3), Rejection)
    r = g.admit("t", queue_depth=4)
    assert isinstance(r, Rejection) and r.code == "queue_full"
    assert r.retry_after_ms == 25.0
    assert _rejects(reg, "t", "queue_full") == 1.0


def test_lifecycle_state_rejects_each_with_counter():
    clk = SimClock()
    g, reg = _gate(clk)
    g.set_state("ld", LOADING)
    g.set_state("dr", DRAINING)
    for tenant, code, retryable in [("ld", "loading", True),
                                    ("dr", "draining", True),
                                    ("nope", "unknown_tenant", False)]:
        r = g.admit(tenant)
        assert isinstance(r, Rejection) and r.code == code, tenant
        assert (r.retry_after_ms is not None) == retryable
        assert _rejects(reg, tenant, code) == 1.0
    g.set_state("ok", READY)
    g.begin_drain()
    r = g.admit("ok")
    assert isinstance(r, Rejection) and r.code == "shutting_down"
    assert r.retry_after_ms is None
    assert _rejects(reg, "ok", "shutting_down") == 1.0


def test_deadline_racing_admission():
    clk = SimClock()
    g, reg = _gate(clk)
    g.set_state("t", READY)
    r = g.admit("t", timeout_ms=0.0)
    assert isinstance(r, Rejection) and r.code == "deadline_expired"
    assert _rejects(reg, "t", "deadline_expired") == 1.0
    tok = g.admit("t", timeout_ms=5.0)
    assert not isinstance(tok, Rejection)
    clk.advance(0.004)
    early = g.admit("t", timeout_ms=5.0)
    assert not isinstance(early, Rejection)
    assert g.settle(early) == "ok"
    clk.advance(0.002)                       # 6 ms > tok's 5 ms budget
    assert g.settle(tok) == "deadline_expired"
    assert reg.value("frontend_deadline_expired_total", tenant="t") == 1.0
    assert g.settle(tok) == "ok"             # a second settle does nothing
    assert g.inflight("t") == 0


def test_unload_while_queued_drains_not_drops():
    """The tenant turns DRAINING with requests queued: new ones bounce
    and never reach the batcher, the queued ones all resolve."""
    clk = SimClock()
    g, reg = _gate(clk, max_inflight=8)
    g.set_state("t", READY)
    b = MicroBatcher(_pure_qfn(), chunk_sizes=(4, 8), max_delay_ms=50.0,
                     clock=clk, tenant="t",
                     metrics=obs_metrics.MetricsRegistry())
    rng = np.random.default_rng(5)
    toks, futs = [], []
    for _ in range(3):
        tok = g.admit("t", rows=2, queue_depth=b.pending())
        assert not isinstance(tok, Rejection)
        toks.append(tok)
        futs.append(b.submit(
            rng.normal(size=(2, N_DIMS)).astype(np.float32), 3))
    assert b.pending() == 3

    g.set_state("t", DRAINING)
    r = g.admit("t", queue_depth=b.pending())
    assert isinstance(r, Rejection) and r.code == "draining"
    assert _rejects(reg, "t", "draining") == 1.0
    assert b.pending() == 3

    assert b.flush_all() >= 1
    for fut in futs:
        ids, dists = fut.result(timeout=5)
        assert ids.shape == (2, 3) and dists.shape == (2, 3)
    for tok in toks:
        assert g.settle(tok, drained=True) == "ok"
    assert reg.value("frontend_drained_requests_total", tenant="t") == 3.0
    assert g.inflight("t") == 0
    assert g.totals() == {"admitted": 3, "rejected": 1, "settled": 3}


# -- batcher clock modes ----------------------------------------------------


def test_wall_clock_mode_bit_identical_to_sim_clock_mode():
    """The pump thread changes when ``pump`` runs, not what a batch
    holds: per-request answers bit-equal to the injected-clock path, and
    shapes from the palette."""
    rng = np.random.default_rng(17)
    reqs = [rng.normal(size=(n, N_DIMS)).astype(np.float32)
            for n in (1, 3, 2, 4, 1, 6, 2, 2)]

    def run_sim():
        clk = SimClock()
        b = MicroBatcher(_pure_qfn(), chunk_sizes=(4, 8), max_delay_ms=2.0,
                         clock=clk, metrics=obs_metrics.MetricsRegistry())
        futs = [b.submit(q, 3) for q in reqs]
        clk.advance(0.003)
        b.pump()
        b.flush_all()
        return [f.result(timeout=5) for f in futs], dict(b.shape_counts)

    def run_wall():
        b = MicroBatcher(_pure_qfn(), chunk_sizes=(4, 8), max_delay_ms=2.0,
                         metrics=obs_metrics.MetricsRegistry()).start()
        try:
            futs = [b.submit(q, 3) for q in reqs]
            return ([f.result(timeout=10) for f in futs],
                    dict(b.shape_counts))
        finally:
            _stop(b)

    sim1, shapes1 = run_sim()
    sim2, shapes2 = run_sim()
    wall, wshapes = run_wall()
    assert shapes1 == shapes2
    for (i1, d1), (i2, d2) in zip(sim1, sim2):
        assert (i1 == i2).all() and (d1 == d2).all()
    for (ids, dists), (wi, wd) in zip(sim1, wall):
        assert ids.dtype == wi.dtype and dists.dtype == wd.dtype
        assert (ids == wi).all() and (dists == wd).all()
    assert set(c for c, _k, _p in wshapes) <= {4, 8}
    assert set(c for c, _k, _p in shapes1) <= {4, 8}


def test_pump_thread_under_concurrent_submitters():
    """More submitting threads than cores, a short switch interval: every
    Future resolves to its own rows' answer, and every request is counted
    once (a lost update under the batcher's lock would break either)."""
    import sys
    import threading
    n_threads = 2 * (os.cpu_count() or 2)
    per = 12
    qfn = _pure_qfn()
    b = MicroBatcher(qfn, chunk_sizes=(4, 8), max_delay_ms=1.0,
                     metrics=obs_metrics.MetricsRegistry())
    errors = []

    def work(i):
        rng = np.random.default_rng(i)
        try:
            for _ in range(per):
                q = rng.normal(size=(int(rng.integers(1, 6)), N_DIMS)
                               ).astype(np.float32)
                ids, dists = b.submit(q, 3).result(timeout=JOIN_S)
                want_i, want_d = qfn(q, 3, 1)
                assert (ids == want_i).all() and (dists == want_d).all()
        except Exception as e:               # noqa: BLE001
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b.start()
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        _stop(b)
        sys.setswitchinterval(old)
    assert not errors, errors
    assert b.n_requests == n_threads * per
    assert b.pending() == 0
    assert set(c for c, _k, _p in b.shape_counts) <= {4, 8}


def test_wait_s_tracks_earliest_deadline():
    clk = SimClock()
    b = MicroBatcher(_pure_qfn(), chunk_sizes=(4, 8), max_delay_ms=10.0,
                     clock=clk, metrics=obs_metrics.MetricsRegistry())
    assert b._wait_s() is None
    b.submit(np.zeros((2, N_DIMS), np.float32), 3)
    assert b._wait_s() == pytest.approx(0.010)
    clk.advance(0.004)
    assert b._wait_s() == pytest.approx(0.006)
    b.submit(np.zeros((1, N_DIMS), np.float32), 5)
    clk.advance(0.005)
    assert b._wait_s() == pytest.approx(0.001)
    clk.advance(0.002)
    assert b._wait_s() == 0.0
    b.pump()
    b.submit(np.zeros((8, N_DIMS), np.float32), 3)
    assert b._wait_s() == 0.0
    b.flush_all()
    assert b._wait_s() is None


# -- WAL lifecycle records and recovery -------------------------------------


def test_wal_lifecycle_record_roundtrip(tmp_path):
    path = str(tmp_path / "t.wal")
    wal = walmod.WriteAheadLog(path)
    for state in ("ready", "draining", "unloaded"):
        wal.append(walmod.encode_lifecycle(state))
    wal.close()
    recs, report = walmod.read_wal(path)
    assert not report["truncated"]
    assert [r.op for r in recs] == [walmod.OP_LIFECYCLE] * 3
    assert walmod.OP_NAMES[walmod.OP_LIFECYCLE] == "lifecycle"
    assert [r.value["state"] for r in recs] == \
        ["ready", "draining", "unloaded"]
    assert walmod.read_last_lifecycle(path) == "unloaded"
    with pytest.raises(ValueError):
        walmod.encode_lifecycle("bogus")
    assert walmod.read_last_lifecycle(str(tmp_path / "no.wal")) is None


def _kw(name, **kw):
    base = dict(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=6,
                bucket_capacity=32, segment_capacity=64, insert_chunk=32,
                chunk_sizes=(4, 8), max_delay_ms=2.0)
    base.update(kw)
    return base


def _spec(name, **kw):
    return ServableSpec(**_kw(name, **kw))


def test_recover_skips_cleanly_unloaded_tenant(tmp_path):
    """A clean unload leaves an audit trail, not an endpoint to bring
    back; a tenant without the final "unloaded" record recovers through
    the lifecycle records in its WAL."""
    wal_dir = str(tmp_path)
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(12, N_DIMS)).astype(np.float32)
    gone, kept = "fe-adm-gone", "fe-adm-kept"

    reg = ServableRegistry(device="cpu", wal_dir=wal_dir)
    for name in (gone, kept):
        reg.register(_spec(name))
        reg.get(name).insert(emb)
        reg.log_lifecycle(name, "ready")
    before = obs_metrics.registry().value(
        "tenant_lifecycle_transitions_total",
        tenant=gone, state="unloaded") or 0.0
    reg.log_lifecycle(gone, "draining")
    reg.log_lifecycle(gone, "unloaded")
    assert obs_metrics.registry().value(
        "tenant_lifecycle_transitions_total",
        tenant=gone, state="unloaded") == before + 1.0
    reg.unregister(gone)
    reg.unregister(kept)                     # no lifecycle record: a crash
    assert reg.names() == []

    reg2 = ServableRegistry(device="cpu", wal_dir=wal_dir)
    reports = reg2.recover(wal_dir=wal_dir)
    assert reg2.names() == [kept]
    assert reports[gone]["skipped"] == "unloaded"
    assert walmod.read_last_lifecycle(
        str(tmp_path / f"{gone}.wal")) == "unloaded"
    ids, _ = reg2.get(kept).index.query(emb[:3], 2, n_probes=2)
    assert tuple(ids.shape) == (3, 2)
    assert reg2.get(kept).index.n_live == 12


# -- the port against the JAX package ---------------------------------------


# (event, tenant, arg): admit's arg is (rows, queue_depth, timeout_ms);
# settle's the index of an open token; advance's seconds
SCRIPT = [
    ("state", "a", READY), ("state", "b", LOADING),
    ("admit", "a", (1, 0, None)), ("admit", "a", (3, 1, 5.0)),
    ("admit", "a", (1, 0, None)),            # over the quota of 2
    ("admit", "b", (1, 0, None)),            # loading
    ("admit", "zz", (1, 0, None)),           # unknown
    ("advance", None, 0.004),
    ("settle", "a", 0), ("admit", "a", (2, 4, None)),   # queue full
    ("admit", "a", (2, 3, 0.0)),             # deadline spent at the door
    ("admit", "a", (2, 3, 1.0)),
    ("advance", None, 0.002),
    ("settle", "a", 0),                      # 5 ms budget, 6 ms late
    ("settle", "a", 0),
    ("state", "b", READY), ("admit", "b", (4, 0, None)),
    ("state", "b", DRAINING), ("admit", "b", (1, 0, None)),
    ("settle_drained", "b", 0),
    ("state", "b", tfe.UNLOADED), ("admit", "b", (1, 0, None)),
    ("admit", "a", (1, 0, None)),
    ("drain", None, None),
    ("admit", "a", (1, 0, None)),            # shutting down
    ("settle_drained", "a", 0),
]


def _run_script(fe_mod, metrics_mod):
    clk = SimClock()
    reg = metrics_mod.MetricsRegistry()
    g = fe_mod.RequestGate(max_inflight=2, queue_depth=4, clock=clk,
                           metrics=reg)
    open_toks = {}
    log = []
    for i, (ev, tenant, arg) in enumerate(SCRIPT):
        if ev == "state":
            g.set_state(tenant, arg)
            log.append(("states", g.states()))
        elif ev == "admit":
            rows, depth, timeout = arg
            out = g.admit(tenant, rows=rows, queue_depth=depth,
                          timeout_ms=timeout)
            if isinstance(out, fe_mod.Rejection):
                log.append(("reject", out.code, out.message,
                            out.retry_after_ms, out.response(i)))
            else:
                open_toks.setdefault(tenant, []).append(out)
                log.append(("admit", out.tenant, out.rows, out.t_admit,
                            out.deadline))
        elif ev.startswith("settle"):
            tok = open_toks[tenant].pop(arg)
            log.append(("settle", g.settle(
                tok, drained=ev == "settle_drained")))
        elif ev == "advance":
            clk.advance(arg)
        elif ev == "drain":
            g.begin_drain()
        log.append(("inflight", {t: g.inflight(t) for t in ("a", "b")},
                    g.total_inflight(), g.totals()))
    series = sorted(reg.collect(), key=lambda x: (
        x["name"], sorted(x["labels"].items())))
    return log, series, (dict(g.admitted), dict(g.rejected),
                         dict(g.settled))


def test_gate_script_equals_the_jax_gate():
    got = _run_script(tfe, obs_metrics)
    want = _run_script(jfe, jmetrics)
    assert got[0] == want[0]
    assert got[2] == want[2]
    strip = [{k: v for k, v in x.items() if k != "t"} for x in got[1]]
    assert strip == [{k: v for k, v in x.items() if k != "t"}
                     for x in want[1]]
    codes = {x[1] for x in got[0] if x[0] == "reject"}
    assert codes == {"overloaded", "loading", "unknown_tenant",
                     "queue_full", "deadline_expired", "draining",
                     "shutting_down"}
    assert tfe.UPDATABLE_FIELDS == jfe.UPDATABLE_FIELDS
    assert (tfe.LOADING, tfe.READY, tfe.DRAINING, tfe.UNLOADED) == \
        (jfe.LOADING, jfe.READY, jfe.DRAINING, jfe.UNLOADED)


def _lifecycle_ops(reg, spec_cls, wal_dir):
    """Register two tenants, insert, walk one through its unload."""
    rng = np.random.default_rng(9)
    for name in ("lc-gone", "lc-kept"):
        reg.register(spec_cls(**_kw(name)))
        reg.get(name).insert(rng.normal(size=(40, N_DIMS)).astype(
            np.float32))
        reg.log_lifecycle(name, "ready")
    reg.get("lc-kept").delete(np.arange(0, 40, 3))
    reg.log_lifecycle("lc-kept", "updated")
    for state in ("draining", "unloaded"):
        reg.log_lifecycle("lc-gone", state)
    reg.unregister("lc-gone")
    return {n: open(os.path.join(wal_dir, f"{n}.wal"), "rb").read()
            for n in ("lc-gone", "lc-kept")}


def test_lifecycle_wal_bytes_equal_the_jax_packages(tmp_path):
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    treg = ServableRegistry(device="cpu", wal_dir=tdir, fsync_every=0)
    jreg = JRegistry(wal_dir=jdir, fsync_every=0)
    got = _lifecycle_ops(treg, ServableSpec, tdir)
    want = _lifecycle_ops(jreg, JSpec, jdir)
    assert got == want
    assert treg.names() == jreg.names() == ["lc-kept"]
    recs, _ = walmod.read_wal(os.path.join(tdir, "lc-gone.wal"))
    assert [r.value["state"] for r in recs
            if r.op == walmod.OP_LIFECYCLE] == \
        ["ready", "draining", "unloaded"]

    # both packages' recovery skip the port's unloaded tenant and rebuild
    # the other from its log
    for reg in (ServableRegistry(device="cpu"), JRegistry()):
        reports = reg.recover(wal_dir=tdir)
        assert reports["lc-gone"]["skipped"] == "unloaded"
        assert reg.names() == ["lc-kept"]
        assert reg.get("lc-kept").index.n_live == 40 - len(range(0, 40, 3))
        assert dataclasses.asdict(reg.get("lc-kept").spec)["name"] == \
            "lc-kept"
