"""The port's network front-end, live, on the CPU.

Mirrors ``tests/test_frontend.py`` for ``repro_torch``: the server runs as
a **real subprocess** (``python -m repro_torch.launch.serve --device cpu
--listen 127.0.0.1:0``) driven by concurrent ``FrontendClient``
connections over real sockets and signals:

* multi-tenant traffic on all three demo tenants answers **bit-equal** to
  direct queries of an in-process registry built from the same specs and
  inserts (invariant 9: the network layer is invisible), and a fourth
  tenant is loaded, served and unloaded over the wire;
* overload (tiny quotas, many clients) gives structured, retryable
  rejects, never an unbounded queue;
* SIGTERM drains: every accepted request is answered, the rest are
  refused ``shutting_down``, the drain line shows ``settled == admitted``
  and the process exits 0.

Then, with the server in this process (an asyncio loop on a thread):

* wire answers against the JAX package's direct answers, with the JAX
  tenants' hash families injected, under ROADMAP's parity contract (ids
  equal where distances are distinct, distances allclose, rows near a
  bucket boundary counted): l2-basis, l1-qmc and w2-quantile at fp32 and
  l2-basis at int8, the ``embed`` verb beside the JAX embedder;
* the JAX package's ``FrontendClient`` against the port's server answers
  as the port's client;
* ``update`` (the new palette, segment wins still counted, a
  replication update accepted as the JAX package accepts it, a family
  field refused), NaN / +-inf query rows, the ``maintenance`` verb (and
  its ``set_replication`` kind) under streamed queries, unknown job ids,
  ``unload`` leaving the
  tenant's index collectable, and the maintenance pool's worker count
  from ``$REPRO_MAINT_WORKERS``.

Ports are always 0; subprocesses inherit no ``REPRO_*`` variable and have
a 120 s timeout; loops, pump threads and pool workers are stopped in a
``finally`` and joined with a timeout; no fixed sleeps (polls with a
deadline); metrics are read from private registries or as deltas under
tenant names unique to this file; no duration is asserted.
"""

import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import client as jclient  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import (BackgroundServer,  # noqa: E402
                               MaintenancePool, ServableRegistry)
from repro_torch.serve.client import FrontendClient, wait_ready  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"
N_DIMS = 16
SEG_CAP = 256
TENANTS = ("l1-qmc", "l2-basis", "w2-quantile")
TIMEOUT_S = 120
JOIN_S = 30.0


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


class _Server:
    """One ``launch.serve --listen`` subprocess; port parsed from stdout."""

    def __init__(self, *extra):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--device", "cpu", "--listen", f"{HOST}:0",
             "--n-dims", str(N_DIMS), "--segment-capacity", str(SEG_CAP),
             *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        try:
            self.port = self._wait_port()
            wait_ready(HOST, self.port, timeout_s=TIMEOUT_S)
        except BaseException:
            self.kill()
            raise

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def _wait_port(self):
        deadline = time.monotonic() + TIMEOUT_S
        while time.monotonic() < deadline:
            for ln in list(self.lines):
                m = re.search(r"listening on [\d.]+:(\d+)", ln)
                if m:
                    return int(m.group(1))
            if self.proc.poll() is not None:
                raise RuntimeError("server died during startup:\n"
                                   + self.proc.stderr.read())
            time.sleep(0.05)
        raise TimeoutError(f"no '[frontend] listening on' line in "
                           f"{TIMEOUT_S}s; got {self.lines}")

    def client(self, cls=FrontendClient):
        return cls(HOST, self.port, timeout_s=60.0)

    def stop(self) -> int:
        """SIGTERM (if alive) and wait; returns the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        self._reader.join(timeout=JOIN_S)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=JOIN_S)
        self._reader.join(timeout=JOIN_S)


def _corpora(seed=7, n=48):
    rng = np.random.default_rng(seed)
    return {t: rng.normal(size=(n, N_DIMS)).astype(np.float32)
            for t in TENANTS}


def _join(threads):
    for th in threads:
        th.join(timeout=TIMEOUT_S)
    assert not any(th.is_alive() for th in threads)


def test_live_multitenant_parity_and_lifecycle():
    srv = _Server()
    try:
        corpora = _corpora()
        with srv.client() as c:
            gids = {t: c.insert(t, corpora[t]) for t in TENANTS}
        for t in TENANTS:
            assert gids[t].tolist() == list(range(48))

        qrng = np.random.default_rng(11)
        slices = ([0, 1, 2], [5, 6, 7, 8, 9], list(range(17, 25)))
        qsets = {t: [corpora[t][s] + qrng.normal(
                        scale=0.05, size=(len(s), N_DIMS)).astype(np.float32)
                     for s in slices] for t in TENANTS}
        results, errors = {}, []

        def run(tenant, worker):
            try:
                with srv.client() as c:
                    for qi, q in enumerate(qsets[tenant]):
                        results[(tenant, worker, qi)] = c.query_arrays(
                            tenant, q, k=5, n_probes=2)
            except Exception as e:           # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(t, w))
                   for t in TENANTS for w in range(2)]
        for th in threads:
            th.start()
        _join(threads)
        assert not errors, errors
        assert len(results) == len(TENANTS) * 2 * len(slices)

        # invariant 9: the same specs, arrays and insert order in this
        # process answer bit for bit
        reg = ServableRegistry(device="cpu")
        for spec in tserve.default_specs(n_dims=N_DIMS,
                                         segment_capacity=SEG_CAP):
            reg.register(spec)
        for t in TENANTS:
            assert reg.get(t).insert(corpora[t]).tolist() == \
                gids[t].tolist()
        for (tenant, _w, qi), (ids, dists) in results.items():
            want_i, want_d = reg.get(tenant).index.query(
                qsets[tenant][qi], 5, n_probes=2)
            assert (want_i.numpy() == ids).all(), (tenant, qi)
            assert (want_d.numpy().view(np.uint32)
                    == dists.view(np.uint32)).all(), (tenant, qi)

        with srv.client() as c:
            h = c.health()
            assert set(h["tenants"]) == set(TENANTS)
            assert all(v["state"] == "ready"
                       for v in h["tenants"].values())
            assert h["draining"] is False
            assert h["totals"]["admitted"] >= len(results)
            st = c.stats()
            assert "frontend_requests_total" in st["catalog"]
            assert "serve_queries_total" in st["catalog"]
            for t in TENANTS:
                assert "qps" in st["report"][t]["stats"]
            assert any(k.startswith("frontend_requests_total")
                       for k in st["metrics"])

            extra_spec = dataclasses.asdict(dataclasses.replace(
                tserve.default_specs(n_dims=N_DIMS,
                                     segment_capacity=SEG_CAP)[0],
                name="extra"))
            assert c.load(extra_spec)["state"] == "ready"
            assert c.health()["tenants"]["extra"]["state"] == "ready"
            c.insert("extra", corpora["l2-basis"][:8])
            ids, _ = c.query_arrays("extra", corpora["l2-basis"][:3], k=2)
            assert ids.shape == (3, 2)
            r = c.unload("extra")
            assert r["state"] == "unloaded" and r["drained"] is True
            resp = c.query("extra", corpora["l2-basis"][:3], k=2)
            assert resp["ok"] is False
            assert resp["code"] == "unknown_tenant"
            assert "extra" not in c.health()["tenants"]
    finally:
        assert srv.stop() == 0


def test_backpressure_under_overload():
    """Tiny quotas and many clients: nonzero structured rejects with
    retry_after_ms, and valid answers for everything accepted."""
    srv = _Server("--max-inflight", "4", "--queue-depth", "2",
                  "--max-delay-ms", "40", "--tenants", "l2-basis")
    try:
        corpus = np.random.default_rng(0).normal(
            size=(64, N_DIMS)).astype(np.float32)
        with srv.client() as c:
            c.insert("l2-basis", corpus)
            c.query_arrays("l2-basis", corpus[:8], k=3)

        oks, rejects, errors = [], [], []
        lock = threading.Lock()

        def blast(seed):
            rng = np.random.default_rng(seed)
            try:
                with srv.client() as c:
                    for _ in range(8):
                        rows = corpus[rng.integers(0, 56, size=8)]
                        r = c.query("l2-basis", rows, k=3)
                        with lock:
                            (oks if r.get("ok") else rejects).append(r)
            except Exception as e:           # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=blast, args=(s,))
                   for s in range(12)]
        for th in threads:
            th.start()
        _join(threads)

        assert not errors, errors
        assert len(oks) + len(rejects) == 12 * 8
        assert rejects, "overload must produce nonzero rejects"
        assert {r["code"] for r in rejects} <= {"overloaded", "queue_full"}
        assert all(r.get("retry_after_ms", 0) > 0 for r in rejects)
        for r in oks:
            assert len(r["gids"]) == 8 and len(r["gids"][0]) == 3
        with srv.client() as c:
            h = c.health()
            assert h["tenants"]["l2-basis"]["inflight"] == 0
            assert h["tenants"]["l2-basis"]["queue_depth"] == 0
            st = c.stats()
            wire_rejects = sum(
                v for k, v in st["metrics"].items()
                if k.startswith("frontend_rejects_total")
                and "l2-basis" in k)
            assert wire_rejects == len(rejects)
    finally:
        assert srv.stop() == 0


def test_sigterm_graceful_drain_loses_no_accepted_request(tmp_path):
    """Streams on every tenant, SIGTERM mid-flight: each stream sees
    answers up to exactly one ``shutting_down`` reject, never a dropped
    connection; the drain line shows settled == admitted; the exported
    metrics hold the front end's series."""
    mdir = str(tmp_path / "metrics")
    srv = _Server("--max-delay-ms", "10", "--metrics-dir", mdir,
                  "--tenant-drain-timeout", "w2-quantile=20")
    try:
        corpora = _corpora(seed=3, n=32)
        with srv.client() as c:
            for t in TENANTS:
                c.insert(t, corpora[t])
                c.query_arrays(t, corpora[t][:4], k=3)

        lock = threading.Lock()
        stats = {"ok": 0, "drain_rejects": 0}
        errors = []

        def stream(tenant, seed):
            rng = np.random.default_rng(seed)
            try:
                with srv.client() as c:
                    while True:
                        q = corpora[tenant][rng.integers(0, 32, size=4)]
                        r = c.query(tenant, q, k=3)
                        if r.get("ok"):
                            assert len(r["gids"]) == 4
                            with lock:
                                stats["ok"] += 1
                        else:
                            assert r["code"] == "shutting_down", r
                            with lock:
                                stats["drain_rejects"] += 1
                            return
            except Exception as e:           # noqa: BLE001
                errors.append(f"{tenant}: {e!r}")

        threads = [threading.Thread(target=stream, args=(t, 100 + i))
                   for i, t in enumerate(TENANTS) for _ in range(2)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + TIMEOUT_S
        while stats["ok"] < 6 * len(threads) and not errors \
                and time.monotonic() < deadline:
            time.sleep(0.01)                 # poll: traffic is flowing
        srv.proc.send_signal(signal.SIGTERM)
        _join(threads)

        rc = srv.stop()
        assert rc == 0
        assert not errors, errors
        assert stats["ok"] >= 6 * len(threads)
        assert stats["drain_rejects"] == len(threads)
        drained = [ln for ln in srv.lines if "drained:" in ln]
        assert drained, srv.lines
        m = re.search(r"admitted=(\d+) settled=(\d+) rejected=(\d+) "
                      r"inflight=(\d+)", drained[0])
        assert m is not None, drained[0]
        assert m.group(1) == m.group(2)
        assert m.group(4) == "0"
        names = {json.loads(x)["name"] for x in open(
            os.path.join(mdir, "metrics.jsonl")) if '"metric"' in x}
        assert {"frontend_requests_total", "frontend_rejects_total",
                "frontend_request_latency_s",
                "frontend_connections_total"} <= names
    finally:
        srv.kill()


# -- the server in this process ----------------------------------------------


class _InProc(BackgroundServer):
    """The port's ``BackgroundServer`` at 127.0.0.1:0, with a private
    metrics registry, one maintenance worker, and every thread it started
    checked dead after ``stop``."""

    def __init__(self, registry, **kw):
        kw.setdefault("metrics", obs_metrics.MetricsRegistry())
        kw.setdefault("drain_timeout_s", 5.0)
        kw.setdefault("maint_workers", 1)
        super().__init__(registry, HOST, 0, timeout_s=TIMEOUT_S, **kw)
        self.fe = self.frontend

    def client(self, cls=FrontendClient):
        return cls(self.host, self.port, timeout_s=60.0)

    def stop(self):
        try:
            super().stop()
        finally:
            self.fe.maintenance.stop(timeout_s=JOIN_S)
        assert not self._thread.is_alive()
        for name in self.fe.registry.names():
            assert self.fe.registry.get(name).batcher._thread is None
        assert not any(t.is_alive() for t in self.fe.maintenance._threads)


def _near(proj):
    return (np.abs(proj - np.round(proj))
            <= 1e-4 + 1e-6 * np.abs(proj)).any(axis=-1)


def _proj(x, fam, r):
    return ref.hash_mm_proj_ref(*(torch.as_tensor(np.array(t)) for t in (
        x, fam[0], fam[1])), r)[1].numpy()


def _assert_parity(g, d, gj, dj, q, emb, fam, r, k):
    """ROADMAP's parity contract: rows whose gids differ must have a query
    or a differing item near a floor boundary (counted, at most 3); every
    other row's gids equal where the reference's distances are distinct,
    and distances of equal gids allclose."""
    q_near = _near(_proj(q, fam, r))
    item_near = set(np.nonzero(_near(_proj(emb, fam, r)))[0])
    rows = np.nonzero((g != gj[:, :k]).any(axis=1))[0]
    explained = [i for i in rows if q_near[i] or (
        set(g[i]) ^ set(gj[i, :k])) & item_near]
    for i in sorted(set(range(len(q))) - set(explained)):
        di = dj[i]
        distinct = np.ones(k, bool)
        distinct[1:] &= di[1:k] != di[:k - 1]
        distinct &= di[:k] != di[1:k + 1]
        np.testing.assert_array_equal(g[i][distinct], gj[i, :k][distinct])
        same = (g[i] == gj[i, :k]) & np.isfinite(di[:k])
        np.testing.assert_allclose(d[i][same], di[:k][same], rtol=1e-5,
                                   atol=1e-6)
    assert len(explained) <= 3, (len(rows), len(explained))


@pytest.mark.parametrize("name,precision", [
    ("l2-basis", "fp32"), ("l1-qmc", "fp32"), ("w2-quantile", "fp32"),
    ("l2-basis", "int8")])
def test_wire_answers_match_the_jax_servable(name, precision):
    k, n_items, n_q = 10, 600, 32
    tspec = {s.name: s for s in tserve.default_specs(
        n_dims=N_DIMS, segment_capacity=SEG_CAP, precision=precision)}[name]
    jspec = {s.name: s for s in jserve.default_specs(
        n_dims=N_DIMS, segment_capacity=SEG_CAP, precision=precision)}[name]
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    tenant = f"fe-jax-{name}-{precision}"
    jreg = JRegistry()
    jsv = jreg.register(dataclasses.replace(jspec, name=tenant))
    fam = tuple(np.asarray(a) for a in jsv.index.family)
    reg = ServableRegistry(device="cpu")
    sv = reg.register(dataclasses.replace(tspec, name=tenant),
                      family=convert.family_from_numpy(*fam, device="cpu"))
    rng = np.random.default_rng(5)
    x, _ = tserve.sample_inputs(sv, rng, n_items)
    xq, _ = tserve.sample_inputs(sv, rng, n_q)
    srv = _InProc(reg)
    try:
        with srv.client() as c:
            emb = c.embed(tenant, x)
            want_emb = np.asarray(jsv.embed(np.asarray(x)))
            np.testing.assert_allclose(emb, want_emb, rtol=0, atol=1e-5)
            if name != "l2-basis":           # QMC and W2 embeds are exact
                np.testing.assert_array_equal(emb, want_emb)
            np.testing.assert_array_equal(
                emb, sv.embed(np.asarray(x, np.float64)).numpy())
            for part in (slice(0, 250), slice(250, n_items)):
                np.testing.assert_array_equal(c.insert(tenant, emb[part]),
                                              jsv.insert(emb[part]))
            victims = np.arange(0, n_items, 11)
            assert c.delete(tenant, victims) == jsv.delete(victims)
            q = c.embed(tenant, xq) + rng.normal(
                scale=0.05, size=(n_q, N_DIMS)).astype(np.float32)
            g, d = c.query_arrays(tenant, q, k=k, n_probes=2)
        gj, dj = (np.asarray(a) for a in jsv.index.query(q, k + 1,
                                                         n_probes=2))
        _assert_parity(g, d, gj, dj, q, emb, fam, tspec.r, k)
        # and bit for bit the port's own direct call
        wg, wd = sv.index.query(q, k, n_probes=2)
        np.testing.assert_array_equal(g, wg.numpy())
        np.testing.assert_array_equal(d.view(np.uint32),
                                      wd.numpy().view(np.uint32))
    finally:
        srv.stop()


def _small_registry(tenant, n=300, seed=4, **kw):
    reg = ServableRegistry(device="cpu")
    spec = dataclasses.replace(tserve.default_specs(
        n_dims=N_DIMS, segment_capacity=128)[0], name=tenant, **kw)
    sv = reg.register(spec)
    emb = np.random.default_rng(seed).normal(size=(n, N_DIMS)).astype(
        np.float32)
    sv.insert(emb)
    return reg, sv, emb


def test_jax_client_answers_as_the_port_client():
    tenant = "fe-compat"
    reg, sv, emb = _small_registry(tenant)
    q = emb[:9] + 0.05
    srv = _InProc(reg)
    try:
        with srv.client() as tc, srv.client(jclient.FrontendClient) as jc:
            for c in (tc, jc):
                assert c.health()["tenants"][tenant]["state"] == "ready"
            tg, td = tc.query_arrays(tenant, q, k=5, n_probes=2)
            jg, jd = jc.query_arrays(tenant, q, k=5, n_probes=2)
            np.testing.assert_array_equal(tg, jg)
            np.testing.assert_array_equal(td.view(np.uint32),
                                          jd.view(np.uint32))
            assert tc.query(tenant, q, k=5)["gids"] == \
                jc.query(tenant, q, k=5)["gids"]
            fv = np.random.default_rng(1).normal(size=(3, N_DIMS))
            np.testing.assert_array_equal(tc.embed(tenant, fv),
                                          jc.embed(tenant, fv))
            assert tc.insert(tenant, emb[:2] + 1).tolist() == [300, 301]
            assert jc.insert(tenant, emb[:2] + 2).tolist() == [302, 303]
            assert tc.delete(tenant, [300]) == jc.delete(tenant, [301]) == 1
            assert tc.compact(tenant) == jc.compact(tenant) == 302
            for c, err in ((tc, jclient.FrontendError),
                           (jc, jclient.FrontendError)):
                r = c.request("nope")
                assert r["ok"] is False and r["code"] == "bad_request"
                assert c.query("missing", q, k=1)["code"] == \
                    "unknown_tenant"
            with pytest.raises(jclient.FrontendError) as je:
                jc.job_status("mj-404")
            from repro_torch.serve.client import FrontendError
            with pytest.raises(FrontendError) as te:
                tc.job_status("mj-404")
            assert je.value.code == te.value.code == "unknown_job"
            assert sorted(tc.stats(tenant)["report"]) == \
                sorted(jc.stats(tenant)["report"])
    finally:
        srv.stop()


def test_update_nan_rows_and_unload():
    tenant = "fe-update"
    reg, sv, emb = _small_registry(tenant)
    q = emb[:16] + 0.05
    ref_g, ref_d = sv.index.query(q, 5, n_probes=2)
    wins = "serve_segment_wins_total"
    gm = obs_metrics.registry()
    unloads = gm.value("tenant_lifecycle_transitions_total", tenant=tenant,
                       state="unloaded") or 0.0
    srv = _InProc(reg)
    try:
        with srv.client() as c:
            g, d = c.query_arrays(tenant, q, k=5, n_probes=2)
            np.testing.assert_array_equal(g, ref_g.numpy())
            np.testing.assert_array_equal(d.view(np.uint32),
                                          ref_d.numpy().view(np.uint32))
            spec = dataclasses.asdict(sv.spec)
            spec.update(chunk_sizes=[4, 16, 64], max_delay_ms=3.0)
            r = c.update(spec)
            assert r["state"] == "ready"
            assert r["changed"] == ["chunk_sizes", "max_delay_ms"]
            assert reg.get(tenant).batcher.chunk_sizes == (4, 16, 64)
            assert reg.get(tenant).batcher.on_answer is not None
            before = sum(v for k_, v in gm.summary(tenant=tenant).items()
                         if k_.startswith(wins))
            g, d = c.query_arrays(tenant, q, k=5, n_probes=2)
            np.testing.assert_array_equal(g, ref_g.numpy())
            np.testing.assert_array_equal(d.view(np.uint32),
                                          ref_d.numpy().view(np.uint32))
            after = sum(v for k_, v in gm.summary(tenant=tenant).items()
                        if k_.startswith(wins))
            assert after > before            # segment wins still counted
            shapes = {ch for ch, _k, _p in reg.get(tenant).batcher
                      .shape_counts}
            assert shapes and shapes <= {4, 16, 64}
            assert c.stats(tenant)["report"]["batcher"]["unique_shapes"] \
                == len(reg.get(tenant).batcher.shape_counts)
            # accepted, as the JAX package's update accepts it; on an
            # unsharded tenant it places nothing and no answer moves
            r = c.update(dict(spec, replication="static:2"))
            assert r["state"] == "ready" and r["changed"] == ["replication"]
            assert reg.get(tenant).spec.replication == "static:2"
            assert reg.get(tenant).index.shard_layout() is None
            g, d = c.query_arrays(tenant, q, k=5, n_probes=2)
            np.testing.assert_array_equal(g, ref_g.numpy())
            np.testing.assert_array_equal(d.view(np.uint32),
                                          ref_d.numpy().view(np.uint32))
            r = c.request("update", spec=dict(spec, replication="static:0"))
            assert r["ok"] is False and r["code"] == "bad_request"
            r = c.request("update", spec=dict(spec, n_tables=2))
            assert r["code"] == "bad_request" and "n_tables" in r["error"]

            nanq = q[:4].copy()
            nanq[0, 3], nanq[2, 0], nanq[3, 5] = np.nan, np.inf, -np.inf
            g, d = c.query_arrays(tenant, nanq, k=5, n_probes=2)
            assert (g[[0, 2, 3]] == -1).all()
            assert np.isposinf(d[[0, 2, 3]]).all()
            np.testing.assert_array_equal(g[1], ref_g.numpy()[1])

            ref_idx = weakref.ref(sv.index)
            del sv
            r = c.unload(tenant)
            assert r["state"] == "unloaded" and r["drained"] is True
            assert c.query(tenant, q, k=5)["code"] == "unknown_tenant"
            assert tenant not in c.health()["tenants"]
        gc.collect()
        assert ref_idx() is None             # nothing holds the index
        assert gm.value("tenant_lifecycle_transitions_total",
                        tenant=tenant, state="unloaded") == unloads + 1.0
    finally:
        srv.stop()


def test_set_replication_over_the_wire_replaces():
    """A sharded tenant on a 4-rank CPU mesh: a ``maintenance`` frame of
    kind ``set_replication`` and an ``update`` of ``replication`` are
    accepted and re-place the tenant (its layout's instances), and every
    wire answer is bit-equal to the direct call."""
    from repro_torch.launch.mesh import make_serve_mesh
    tenant = "fe-replicate"
    reg = ServableRegistry(device="cpu",
                           mesh=make_serve_mesh(4, device="cpu"))
    spec = dataclasses.replace(tserve.default_specs(
        n_dims=N_DIMS, segment_capacity=64, shard_axis="serve")[0],
        name=tenant)
    sv = reg.register(spec)
    emb = np.random.default_rng(9).normal(size=(400, N_DIMS)).astype(
        np.float32)
    sv.insert(emb)
    sv.delete(np.arange(0, 400, 5))
    q = emb[:8] + 0.05
    want = sv.index.query(q, 5, n_probes=2)
    lay = sv.index.shard_layout()
    assert (lay["n_dev"], lay["n_sealed"], lay["n_instances"]) == (4, 6, 6)

    def wire_equals_direct(c):
        g, d = c.query_arrays(tenant, q, k=5, n_probes=2)
        dg, dd = sv.index.query(q, 5, n_probes=2)
        np.testing.assert_array_equal(g, dg.numpy())
        np.testing.assert_array_equal(d.view(np.uint32),
                                      dd.numpy().view(np.uint32))
        np.testing.assert_array_equal(g, want[0].numpy())

    srv = _InProc(reg)
    try:
        with srv.client() as c:
            wire_equals_direct(c)
            job = c.maintenance(tenant, "set_replication",
                                replication=[3, 1, 1, 1, 1, 2])
            assert c.wait_job(job, timeout_s=TIMEOUT_S)["status"] == "done"
            lay = sv.index.shard_layout()
            assert lay["replication"] == [3, 1, 1, 1, 1, 2]
            assert lay["n_instances"] == 9
            # refreshed by the job, not by the next query
            assert sv.index._placement.n_sealed == 6
            assert sv.index._router is not None
            for _ in range(3):               # routed batches rotate replicas
                wire_equals_direct(c)
            r = c.update(dict(dataclasses.asdict(sv.spec),
                              replication="static:4"))
            assert r["changed"] == ["replication"]
            assert sv.index.replication() == 4
            assert sv.index.shard_layout()["n_instances"] == 24
            wire_equals_direct(c)
            r = c.update(dict(dataclasses.asdict(sv.spec),
                              replication="none"))
            assert sv.index.replication() is None
            assert sv.index._router is None
            wire_equals_direct(c)
    finally:
        srv.stop()


def test_maintenance_verb_under_streamed_queries():
    tenant = "fe-maint"
    reg, sv, emb = _small_registry(tenant, n=600)
    q = emb[:8] + 0.05
    srv = _InProc(reg)
    try:
        with srv.client() as c:
            assert c.delete(tenant, np.arange(0, 600, 3)) == 200
            pre = c.query_arrays(tenant, q, k=5, n_probes=2)
            answers, stop, errors = [], threading.Event(), []

            def stream():
                try:
                    with srv.client() as sc:
                        while not stop.is_set():
                            answers.append(sc.query_arrays(
                                tenant, q, k=5, n_probes=2))
                except Exception as e:       # noqa: BLE001
                    errors.append(repr(e))

            threads = [threading.Thread(target=stream) for _ in range(2)]
            for th in threads:
                th.start()
            try:
                deadline = time.monotonic() + TIMEOUT_S
                while len(answers) < 2 and not errors \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)        # poll: the streams are up
                job = c.maintenance(tenant, "compact")
                st = c.wait_job(job, timeout_s=TIMEOUT_S)
            finally:
                stop.set()
                _join(threads)
            assert not errors, errors
            assert st["status"] == "done" and st["kind"] == "compact"
            assert st["result"] == {"n_segments": 4, "n_live": 400}
            post = c.query_arrays(tenant, q, k=5, n_probes=2)

            def same(a, b):
                return (a[0] == b[0]).all() and \
                    (a[1].view(np.uint32) == b[1].view(np.uint32)).all()
            assert answers
            assert all(same(a, pre) or same(a, post) for a in answers)
            assert c.request("job_status", job_id="mj-999")["code"] == \
                "unknown_job"
            # the JAX package's third kind: accepted, run, and on this
            # unsharded tenant no answer moves
            job = c.maintenance(tenant, "set_replication", replication=2)
            st = c.wait_job(job, timeout_s=TIMEOUT_S)
            assert st["result"] == {"replication": 2}
            assert reg.get(tenant).index.replication() == 2
            assert same(c.query_arrays(tenant, q, k=5, n_probes=2), post)
            r = c.request("maintenance", tenant=tenant, kind="defrag")
            assert r["code"] == "bad_request"
            r = c.request("maintenance", tenant="fe-nobody", kind="seal")
            assert r["code"] == "unknown_tenant"
            job = c.maintenance(tenant, "seal", note="kept")
            assert c.wait_job(job)["result"] == {"n_segments": 5}
            pj = srv.fe.maintenance._jobs[job]
            assert pj.params == {"note": "kept"}
            assert pj.finished_s >= pj.submitted_s > 0
    finally:
        srv.stop()


def test_pool_workers_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_MAINT_WORKERS", "3")
    pool = MaintenancePool(ServableRegistry(device="cpu"))
    try:
        assert pool.workers == 3
    finally:
        pool.stop(timeout_s=JOIN_S)
    assert not any(t.is_alive() for t in pool._threads)
    monkeypatch.delenv("REPRO_MAINT_WORKERS")
    pool = MaintenancePool(ServableRegistry(device="cpu"))
    try:
        assert pool.workers == 1
    finally:
        pool.stop(timeout_s=JOIN_S)
    assert not any(t.is_alive() for t in pool._threads)
