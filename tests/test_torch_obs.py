"""The port's telemetry (``repro_torch.obs``) against the JAX package's, on
the CPU.

Mirrors the in-process groups of ``tests/test_obs.py`` for the port (the
registry's catalog enforcement, the tracer's sampling, ring, nesting and
attach, the exporter's JSON lines and Prometheus text, ``ServingStats``
under an injected clock, the batcher's queue wait, invariant 8) and holds
the port to the JAX package:

* ``CATALOG`` and ``STAGE_SPANS`` equal the JAX package's, entry by entry,
  and the same seed samples the same traces;
* at sample 0 a query is bit-identical to an untraced one and records no
  span; the deep-traced staged query is bit-identical (gids and distance
  bits) to ``query()`` at 32 and 128 rows, 1 and 4 probes, also after a
  compaction, and equal to the JAX package's staged query under the parity
  contract (ids equal where the JAX distances are distinct, distances
  ``rtol=1e-6, atol=1e-6``);
* the same inserts, deletes, queries, seal, compaction, snapshots,
  corrupt step, fault, standby, promotion and recovery run through both
  packages give equal counter deltas and equal histogram observation
  counts, ``wal_bytes_total`` included (the frames are byte-identical);
* the port launcher's ``--metrics-dir`` export passes
  ``tools/check_metrics_export.py`` but for the one metric only a
  multi-device serve emits.

Rules these tests keep, because pytest-xdist runs many files in one
process: the registry, tracer and exporter tests build their own
``MetricsRegistry`` / ``Tracer``; tests that read the process-wide
registry compare deltas taken around their own actions, under a tenant
name unique to the test, and never reset it; every ``configure`` is undone
(the autouse fixture restores the process tracer whatever a test did);
no test asserts a duration; every thread is stopped in a ``finally`` and
every join or wait has a timeout; subprocesses inherit no ``REPRO_*``
variable and have a timeout.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve.maintenance import MaintenancePool as JPool  # noqa: E402
from repro.serve.standby import WalStandby as JStandby  # noqa: E402
from repro.core.index import IndexConfig as JConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.index import IndexConfig  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.metrics import CATALOG, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve import (MaintenancePool, MicroBatcher,  # noqa: E402
                               SegmentedIndex, ServableRegistry,
                               ServableSpec, ServingStats, WalStandby,
                               faults)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DIMS = 16


def _tenant() -> str:
    """A tenant name no other test uses (the registry is process-wide)."""
    return "obs-" + uuid.uuid4().hex[:10]


@pytest.fixture(autouse=True)
def _restore_process_state():
    """Whatever a test configures, the process tracer (both packages') is
    put back as it was, and no fault plan outlives the test."""
    saved = []
    for tr in (obs_trace.tracer(), jtrace.tracer()):
        saved.append((tr, tr.sample_rate, tr.deep, tr.clock, tr._seed,
                       tr._ring.maxlen))
    faults.clear()
    jfaults.clear()
    try:
        yield
    finally:
        faults.clear()
        jfaults.clear()
        for tr, rate, deep, clock, seed, maxlen in saved:
            tr.sample_rate, tr.deep, tr.clock, tr._seed = (rate, deep, clock,
                                                           seed)
            if tr._ring.maxlen != maxlen:
                with tr._lock:
                    tr._ring = type(tr._ring)(tr._ring, maxlen=maxlen)


# ---------------------------------------------------------------------------
# the schema: one catalog, one stage taxonomy
# ---------------------------------------------------------------------------


def test_catalog_equals_the_jax_catalog():
    assert list(CATALOG) == list(jmetrics.CATALOG)
    for name, spec in CATALOG.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jmetrics.CATALOG[name]), name
    assert obs_metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_stage_spans_equal_the_jax_taxonomy():
    assert obs_trace.STAGE_SPANS == jtrace.STAGE_SPANS


def test_sampling_matches_the_jax_tracer():
    """The same seed and rate sample the same trace ids."""
    a, b = Tracer(sample_rate=0.3, seed=99), jtrace.Tracer(sample_rate=0.3,
                                                           seed=99)
    for _ in range(100):
        ca, cb = a.start_trace(), b.start_trace()
        assert (ca.trace_id, ca.sampled) == (cb.trace_id, cb.sampled)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.inc("serve_queries_total", 3, tenant="t")
    reg.inc("serve_queries_total", 2, tenant="t")
    reg.set("serve_recall_proxy", 0.75, tenant="t")
    reg.observe("serve_query_latency_s", 0.005, tenant="t")
    reg.observe("serve_query_latency_s", 2.0, tenant="t")
    assert reg.value("serve_queries_total", tenant="t") == 5
    assert reg.value("serve_recall_proxy", tenant="t") == 0.75
    h = reg.value("serve_query_latency_s", tenant="t")
    assert h["count"] == 2 and abs(h["sum"] - 2.005) < 1e-9
    assert h["buckets"][-1] == ["+Inf", 2]
    entries = {e["name"]: e for e in reg.collect()}
    assert entries["serve_queries_total"]["labels"] == {"tenant": "t"}
    assert entries["serve_query_latency_s"]["type"] == "histogram"


def test_registry_rejects_schema_drift():
    reg = MetricsRegistry()
    with pytest.raises(KeyError):
        reg.inc("not_a_documented_metric", tenant="t")
    with pytest.raises(ValueError):
        reg.inc("serve_queries_total", shard="0")
    with pytest.raises(ValueError):
        reg.inc("serve_queries_total")
    with pytest.raises(TypeError):
        reg.set("serve_queries_total", 1.0, tenant="t")
    with pytest.raises(ValueError):
        reg.inc_each("serve_queries_total", "segment", [(0, 1)], tenant="t")
    with pytest.raises(ValueError):
        reg.inc_each("serve_recall_proxy", "tenant", [("t", 1)])


def test_registry_summary_filters_by_label():
    reg = MetricsRegistry()
    reg.inc("serve_queries_total", 7, tenant="a")
    reg.inc("serve_queries_total", 9, tenant="b")
    reg.inc("serve_segment_wins_total", 4, tenant="a", segment="2")
    s = reg.summary(tenant="a")
    assert s["serve_queries_total"] == 7
    assert s["serve_segment_wins_total{segment=2}"] == 4
    assert not any("9" == str(v) for v in s.values())


def test_inc_each_equals_one_inc_per_series():
    one, each = MetricsRegistry(), MetricsRegistry()
    wins = [(0, 3), (5, 1), (257, 2), (5, 4)]
    for seg, w in wins:
        one.inc("serve_segment_wins_total", w, tenant="t", segment=seg)
    each.inc_each("serve_segment_wins_total", "segment", wins, tenant="t")
    assert one.collect() == each.collect()


def test_registry_generation_and_reset_on_a_private_registry():
    reg = MetricsRegistry()
    obs = reg.observe_handle("serve_stage_latency_s", tenant="t",
                             stage="hash")
    obs(0.5)
    g = reg.generation
    reg.reset()
    assert reg.generation == g + 1 and reg.collect() == []


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_sampling_is_deterministic_in_trace_id():
    a = Tracer(sample_rate=0.5, seed=1234)
    b = Tracer(sample_rate=0.5, seed=1234)
    da = [a.start_trace().sampled for _ in range(200)]
    db = [b.start_trace().sampled for _ in range(200)]
    assert da == db
    assert 0.3 < sum(da) / len(da) < 0.7
    assert Tracer(sample_rate=0.0).start_trace() is None


def test_span_ring_is_bounded():
    tr = Tracer(sample_rate=1.0, buffer=16, metrics=MetricsRegistry())
    for i in range(50):
        with tr.span("hash", tenant="t", i=i):
            pass
    spans = tr.spans()
    assert len(spans) == 16
    assert [s["attrs"]["i"] for s in spans] == list(range(34, 50))
    assert tr.n_spans == 50
    assert tr.drain() and tr.spans() == []


def test_span_nesting_and_attach():
    tr = Tracer(sample_rate=1.0, metrics=MetricsRegistry())
    with tr.span("request", tenant="t") as root:
        ctx = tr.current()
        assert ctx is not None and ctx.sampled and tr.sampled()
        with tr.span("hash", tenant="t") as child:
            assert child.parent_id == root.span_id
        tr.record("admission", 1.0, 2.0, tenant="t")
    assert tr.current() is None
    by_name = {s["name"]: s for s in tr.spans()}
    assert by_name["hash"]["parent_id"] == by_name["request"]["span_id"]
    assert by_name["admission"]["parent_id"] == by_name["request"]["span_id"]
    assert by_name["request"]["parent_id"] is None
    assert len({s["trace_id"] for s in tr.spans()}) == 1
    # attach carries a context to another thread
    seen = []

    def other():
        with tr.attach(ctx):
            seen.append(tr.current() is ctx)
        seen.append(tr.current() is None)
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [True, True]


def test_unsampled_context_suppresses_descendants():
    tr = Tracer(sample_rate=0.5, seed=0, metrics=MetricsRegistry())
    for _ in range(100):
        ctx = tr.start_trace()
        if not ctx.sampled:
            break
    assert not ctx.sampled
    with tr.attach(ctx):
        assert tr.span("hash", tenant="t") is obs_trace._NOOP
    assert tr.spans() == []


def test_stage_spans_feed_latency_histogram():
    reg = MetricsRegistry()
    tr = Tracer(sample_rate=1.0, metrics=reg)
    with tr.span("gather", tenant="t"):
        pass
    with tr.span("not_a_stage", tenant="t"):
        pass
    assert reg.value("serve_stage_latency_s", tenant="t",
                     stage="gather")["count"] == 1
    assert reg.value("serve_stage_latency_s", tenant="t",
                     stage="not_a_stage") is None
    # a reset registry: the cached handle is re-acquired
    reg.reset()
    with tr.span("gather", tenant="t"):
        pass
    assert reg.value("serve_stage_latency_s", tenant="t",
                     stage="gather")["count"] == 1


def test_env_knobs_are_read_when_the_tracer_is_built(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("REPRO_TRACE_BUFFER", "7")
    monkeypatch.setenv("REPRO_TRACE_DEEP", "1")
    tr = Tracer(metrics=MetricsRegistry())
    assert (tr.sample_rate, tr.deep, tr._ring.maxlen) == (0.25, True, 7)
    monkeypatch.setenv("REPRO_TRACE_DEEP", "0")
    monkeypatch.delenv("REPRO_TRACE_SAMPLE")
    tr = Tracer(metrics=MetricsRegistry())
    assert (tr.sample_rate, tr.deep) == (0.0, False)
    assert tr.stats()["spans_buffered"] == 0


def test_configure_changes_the_process_tracer_in_place():
    tr = obs_trace.tracer()
    try:
        got = obs_trace.configure(sample_rate=1.0, deep=True, buffer=5)
        assert got is tr and tr.sample_rate == 1.0 and tr.deep
        assert tr._ring.maxlen == 5
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False, buffer=4096)
    assert tr.sample_rate == 0.0 and not tr.deep


# ---------------------------------------------------------------------------
# ServingStats time semantics (injected clock) and the batcher
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stats(clock, **kw):
    return ServingStats(clock=clock, tenant="t", metrics=MetricsRegistry(),
                        **kw)


def test_window_trim_at_exact_boundary():
    clock = _Clock()
    st = _stats(clock, window_s=10.0)
    st.record_query(4)
    clock.t = 10.0
    assert st.qps() == pytest.approx(4 / 10.0)
    clock.t = 10.0 + 1e-6
    assert st.qps() == 0.0


def test_latency_reservoir_wraps_as_a_ring():
    clock = _Clock()
    st = _stats(clock, reservoir=8)
    for i in range(1, 21):
        st.record_query(1, latency_s=float(i))
    assert st._lat_n == 20
    p = st.latency_percentiles()
    assert p["p50_ms"] == pytest.approx(
        float(np.percentile(np.arange(13, 21) * 1e3, 50)))
    assert p["p99_ms"] <= 20_000.0 and p["p50_ms"] >= 13_000.0
    h = st.metrics.value("serve_query_latency_s", tenant="t")
    assert h["count"] == 20 and h["sum"] == pytest.approx(210.0)


def test_rate_with_single_event():
    clock = _Clock()
    st = _stats(clock)
    clock.t = 5.0
    st.record_query(6)
    assert np.isfinite(st.qps()) and st.qps() > 0
    clock.t = 8.0
    assert st.qps() == pytest.approx(6 / 3.0)
    assert _stats(clock).qps() == 0.0


def test_padding_efficiency_and_the_counters():
    clock = _Clock()
    st = _stats(clock)
    assert st.padding_efficiency() == 1.0
    st.record_batch(30, 32, 0.01)
    st.record_batch(16, 32, 0.01)
    assert st.padding_efficiency() == pytest.approx(46 / 64)
    assert st.snapshot()["padding_efficiency"] == pytest.approx(0.7188,
                                                                abs=1e-4)
    st.record_recall(0.9)
    st.record_insert(5)
    st.record_delete(2)
    st.record_rejected(3)
    st.record_fanout(np.array([0, 4, 0, 1]))
    m = st.metrics
    assert st.snapshot()["recall_proxy"] == 0.9
    want = {"serve_batch_rows_real_total": 46,
            "serve_batch_rows_padded_total": 18, "serve_batches_total": 2,
            "serve_queries_total": 46, "serve_inserts_total": 5,
            "serve_deletes_total": 2, "serve_rejected_inserts_total": 3,
            "serve_recall_proxy": 0.9}
    for name, v in want.items():
        assert m.value(name, tenant="t") == v, name
    assert m.summary(tenant="t")["serve_segment_wins_total{segment=1}"] == 4
    assert m.value("serve_segment_wins_total", tenant="t",
                   segment=0) is None


def test_queue_wait_histogram_from_batcher():
    clock = _Clock()
    reg = MetricsRegistry()
    calls = []

    def qfn(q, k, npb):
        calls.append(q.shape)
        return (np.zeros((q.shape[0], k), np.int32),
                np.zeros((q.shape[0], k), np.float32))

    b = MicroBatcher(qfn, chunk_sizes=(8,), max_delay_ms=5.0, clock=clock,
                     tenant="t", metrics=reg)
    b.submit(np.zeros((3, 4), np.float32), k=2)
    clock.t = 0.25
    b.flush_all()
    h = reg.value("serve_queue_wait_s", tenant="t")
    assert h["count"] == 1
    assert h["sum"] == pytest.approx(0.25)
    assert calls == [(8, 4)]


def test_batcher_spans_are_structured():
    """A sampled request: admission and batch spans in its trace, the
    query function's own span inside the batch span (structure only: no
    duration is asserted)."""
    tr = obs_trace.tracer()
    tr.drain()
    name = _tenant()

    def qfn(q, k, npb):
        with tr.span("hash", tenant=name):
            pass
        return (np.zeros((q.shape[0], k), np.int32),
                np.zeros((q.shape[0], k), np.float32))

    b = MicroBatcher(qfn, chunk_sizes=(8,), tenant=name)
    try:
        obs_trace.configure(sample_rate=1.0)
        b.query(np.zeros((3, 4), np.float32), k=2)
    finally:
        obs_trace.configure(sample_rate=0.0)
        spans = [s for s in tr.drain() if s["attrs"].get("tenant") == name]
    by = {s["name"]: s for s in spans}
    assert set(by) == {"admission", "batch", "hash"}
    assert len({s["trace_id"] for s in spans}) == 1
    assert by["hash"]["parent_id"] == by["batch"]["span_id"]
    assert by["batch"]["attrs"]["rows_real"] == 3
    _assert_nested(spans)


def _assert_nested(spans):
    """t1 >= t0 for every span, and each child inside its parent."""
    sid = {s["span_id"]: s for s in spans}
    for s in spans:
        assert s["t1"] >= s["t0"], s
        p = sid.get(s["parent_id"])
        if p is not None and s["name"] != "admission":
            # admission is written retroactively, from the submit time
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)


# ---------------------------------------------------------------------------
# invariant 8: tracing is invisible; the staged engine
# ---------------------------------------------------------------------------


def _family(seed=0):
    cfg = JConfig(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
                  bucket_capacity=32, r=4.0)
    j = JSegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                        seed=seed)
    return cfg, j, convert.family_from_numpy(
        *(np.asarray(a) for a in j.family), device="cpu")


def _small_index(seed=0, tenant="t", compacted=False, with_jax=False):
    """A port index (and, with ``with_jax``, the JAX package's with the
    same family and items): 300 items in 64-row segments, every 7th
    deleted, optionally compacted."""
    jcfg, jidx, fam = _family(seed)
    cfg = IndexConfig(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
                      bucket_capacity=32, r=4.0)
    idx = SegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                         family=fam, device="cpu", tenant=tenant)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, N_DIMS)).astype(np.float32)
    g = idx.insert(x)
    idx.delete(g[::7])
    if with_jax:
        jidx.insert(x)
        jidx.delete(g[::7])
    if compacted:
        idx.maintenance.compact()
        if with_jax:
            jidx.maintenance.compact()
    return idx, (jidx if with_jax else None), rng


def _bits(g, d):
    return np.asarray(g), np.asarray(d).view(np.uint32)


def test_rate0_bit_identical_and_span_free():
    idx, _, rng = _small_index()
    q = rng.normal(size=(8, N_DIMS)).astype(np.float32)
    base = _bits(*idx.query(q, 5, n_probes=3))
    tr = obs_trace.tracer()
    before = tr.n_spans
    try:
        obs_trace.configure(sample_rate=0.0, deep=True)
        got = _bits(*idx.query(q, 5, n_probes=3))
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
    np.testing.assert_array_equal(base[0], got[0])
    np.testing.assert_array_equal(base[1], got[1])
    assert tr.n_spans == before


STAGES = ("hash", "probe", "gather", "rerank", "merge")


@pytest.mark.parametrize("compacted", [False, True])
@pytest.mark.parametrize("n_probes", [1, 4])
@pytest.mark.parametrize("rows", [32, 128])
def test_staged_query_bit_identical(rows, n_probes, compacted):
    name = _tenant()
    idx, _, rng = _small_index(seed=3, tenant=name, compacted=compacted)
    q = rng.normal(size=(rows, N_DIMS)).astype(np.float32)
    base = _bits(*idx.query(q, 10, n_probes=n_probes))
    tr = obs_trace.tracer()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        with tr.span("request", tenant=name):
            got = _bits(*idx.query(q, 10, n_probes=n_probes))
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        spans = [s for s in tr.drain() if s["attrs"].get("tenant") == name]
    np.testing.assert_array_equal(base[0], got[0])
    np.testing.assert_array_equal(base[1], got[1])
    names = [s["name"] for s in spans]
    assert names == list(STAGES) + ["request"]
    root = spans[-1]
    assert all(s["parent_id"] == root["span_id"] for s in spans[:-1])
    assert len({s["trace_id"] for s in spans}) == 1
    _assert_nested(spans)


def test_staged_query_equals_the_jax_staged_query():
    """Both packages' deep-traced queries on the same family and items:
    ids equal where the JAX distances are distinct, distances rtol 1e-6,
    atol 1e-6."""
    idx, jidx, rng = _small_index(seed=4, tenant=_tenant(), with_jax=True)
    q = rng.normal(size=(32, N_DIMS)).astype(np.float32)
    tr, jtr = obs_trace.tracer(), jtrace.tracer()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        jtrace.configure(sample_rate=1.0, deep=True)
        with tr.span("request"):
            g, d = idx.query(q, 10, n_probes=4)
        with jtr.span("request"):
            jg, jd = jidx.query(jnp.asarray(q), 10, n_probes=4)
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        jtrace.configure(sample_rate=0.0, deep=False)
        names = [s["name"] for s in tr.drain()]
        jnames = {s["name"] for s in jtr.drain()}
    assert set(STAGES) <= jnames and names[:5] == list(STAGES)
    g, d, jg, jd = (np.asarray(a) for a in (g, d, jg, jd))
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-6)
    for r in range(jg.shape[0]):
        with np.errstate(invalid="ignore"):      # inf - inf past the hits
            step = np.diff(jd[r]) > 0
        distinct = np.isfinite(jd[r]) & np.r_[True, step] & np.r_[step, True]
        np.testing.assert_array_equal(g[r][distinct], jg[r][distinct])


def test_quantized_tier_never_runs_staged():
    name = _tenant()
    _, _, fam = _family(5)
    cfg = IndexConfig(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
                      bucket_capacity=32, r=4.0)
    idx = SegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                         family=fam, device="cpu", tenant=name,
                         precision="int8")
    idx.insert(np.random.default_rng(5).normal(size=(200, N_DIMS))
               .astype(np.float32))
    q = np.random.default_rng(6).normal(size=(8, N_DIMS)).astype(np.float32)
    base = _bits(*idx.query(q, 10, n_probes=2))
    tr = obs_trace.tracer()
    m = obs_metrics.registry()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        with tr.span("request", tenant=name):
            got = _bits(*idx.query(q, 10, n_probes=2))
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        names = [s["name"] for s in tr.drain()
                 if s["attrs"].get("tenant") == name]
    np.testing.assert_array_equal(base[0], got[0])
    np.testing.assert_array_equal(base[1], got[1])
    assert names == ["request"]
    assert 0.0 < m.value("rerank_survivor_frac", tenant=name) <= 1.0
    assert m.value("store_bytes_per_item", tenant=name) == \
        idx.store_bytes_per_item()


# ---------------------------------------------------------------------------
# one sampled request through a servable: every span of its trace
# ---------------------------------------------------------------------------


def test_servable_request_trace_covers_every_stage():
    name = _tenant()
    reg = ServableRegistry(device="cpu")
    sv = reg.register(ServableSpec(name=name, n_dims=N_DIMS, r=2.0,
                                   log2_buckets=8, bucket_capacity=64,
                                   segment_capacity=64, insert_chunk=32,
                                   chunk_sizes=(32,)))
    rng = np.random.default_rng(0)
    for _ in range(4):
        sv.insert(sv.embed(rng.normal(size=(64, len(sv.nodes())))))
    fv = rng.normal(size=(20, len(sv.nodes())))
    base = sv.query(sv.embed(fv).numpy(), 10, 3)
    m = obs_metrics.registry()
    before = m.summary(tenant=name)
    tr = obs_trace.tracer()
    tr.drain()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        with tr.span("request", tenant=name):
            q = sv.embed(fv).numpy()
            fut = sv.submit_query(q, 10, n_probes=3)
            sv.batcher.flush_all()
            g, d = fut.result(timeout=60)
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        spans = [s for s in tr.drain() if s["attrs"].get("tenant") == name]
    after = m.summary(tenant=name)
    np.testing.assert_array_equal(base[0], g)
    np.testing.assert_array_equal(base[1].view(np.uint32),
                                  d.view(np.uint32))
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    assert set(by) == {"request", "embed", "admission", "batch",
                       *STAGES}, sorted(by)
    assert len({s["trace_id"] for s in spans}) == 1
    root = by["request"][0]
    sid = {s["span_id"]: s for s in spans}
    for s in spans:
        p = s
        while p["parent_id"] is not None:
            p = sid[p["parent_id"]]
        assert p is root
    batch = by["batch"][0]
    assert {s["parent_id"] for n in STAGES for s in by[n]} == {
        batch["span_id"]}
    _assert_nested(spans)

    def delta(key):
        a, b = after.get(key, 0), before.get(key, 0)
        if isinstance(a, dict):
            return a["count"] - (b["count"] if b else 0)
        return a - b
    # the stage histogram saw each stage once; the report's metrics
    # summary counts the request's rows and, from the hook, the wins of
    # the whole padded chunk (the JAX package attributes the padding too)
    for stage in STAGES:
        assert delta(f"serve_stage_latency_s{{stage={stage}}}") == 1
    assert sv.report()["metrics"] == m.summary(tenant=name)
    assert delta("serve_queries_total") == 20
    chunk = np.zeros((32, N_DIMS), np.float32)
    chunk[:20] = q
    held = int((sv.index.query(chunk, 10, 3)[0].numpy() >= 0).sum())
    wins = sum(delta(k) for k in after
               if k.startswith("serve_segment_wins_total"))
    assert wins == held


def test_sharded_deep_trace_covers_every_stage():
    """One sampled request to a tenant sharded over an 8-rank CPU mesh:
    the staged sharded query runs under the hash, probe, gather, rerank,
    merge and fanin spans, all children of the batch span in the request's
    one trace, bit-equal to the untraced query, and the wins land per rank
    (the JAX package's ``tests/test_obs.py::
    test_sharded_deep_trace_covers_every_stage``)."""
    from repro_torch.launch.mesh import make_serve_mesh
    name = _tenant()
    reg = ServableRegistry(device="cpu",
                           mesh=make_serve_mesh(8, device="cpu"))
    sv = reg.register(ServableSpec(
        name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8, bucket_capacity=64,
        segment_capacity=64, insert_chunk=32, chunk_sizes=(128,),
        max_delay_ms=1.0, shard_axis="serve"))
    rng = np.random.default_rng(0)
    for _ in range(6):                       # several sealed segments
        sv.insert(rng.normal(size=(64, N_DIMS)).astype(np.float32))
    fv = rng.normal(size=(128, len(sv.nodes())))
    q_base = sv.embed(fv).numpy()
    base_g, base_d = (t.numpy() for t in sv.index.query(q_base, 10, 3))
    m = obs_metrics.registry()
    tr = obs_trace.tracer()
    tr.drain()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        with tr.span("request", tenant=name):
            fut = sv.submit_query(sv.embed(fv).numpy(), 10, n_probes=3)
            sv.batcher.flush_all()
            g, d = fut.result(timeout=60)
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        spans = [s for s in tr.drain() if s["attrs"].get("tenant") == name]
    np.testing.assert_array_equal(base_g, g)
    np.testing.assert_array_equal(base_d.view(np.uint32), d.view(np.uint32))
    assert len({s["trace_id"] for s in spans}) == 1
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    for stage in ("request", "admission", "embed", "batch", *STAGES,
                  "fanin"):
        assert stage in by, f"missing span {stage}: {sorted(by)}"
    batch = by["batch"][0]
    assert {s["parent_id"] for n in (*STAGES, "fanin") for s in by[n]} == {
        batch["span_id"]}
    _assert_nested(spans)
    dev = [m.value("serve_device_wins_total", tenant=name, device=str(r))
           for r in range(8)]
    assert sum(v or 0 for v in dev) == int((g >= 0).sum())


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------


def test_exporter_jsonl_and_prometheus(tmp_path):
    reg = MetricsRegistry()
    tr = Tracer(sample_rate=1.0, metrics=reg)
    reg.inc("serve_queries_total", 12, tenant="t")
    reg.observe("wal_fsync_latency_s", 0.002, tenant="t")
    with tr.span("hash", tenant="t"):
        pass
    exp = obs_export.Exporter(str(tmp_path / "metrics.jsonl"),
                              registry=reg, tracer=tr,
                              prom_path=str(tmp_path / "metrics.prom"))
    try:
        assert exp.flush() >= 4
        lines = [json.loads(x) for x in
                 (tmp_path / "metrics.jsonl").read_text().splitlines()]
        metrics = [o for o in lines if o["kind"] == "metric"]
        spans = [o for o in lines if o["kind"] == "span"]
        assert len({o["ts"] for o in metrics}) == 1
        for o in metrics:
            spec = CATALOG[o["name"]]
            assert o["type"] == spec.type
            assert sorted(o["labels"]) == sorted(spec.labels)
        assert spans and spans[0]["name"] == "hash"
        assert spans[0]["t1"] >= spans[0]["t0"]
        exp.flush()
        again = [json.loads(x) for x in
                 (tmp_path / "metrics.jsonl").read_text().splitlines()]
        assert sum(o["kind"] == "span" for o in again) == 1
        prom = (tmp_path / "metrics.prom").read_text()
        assert 'serve_queries_total{tenant="t"} 12' in prom
        assert "# TYPE wal_fsync_latency_s histogram" in prom
        assert 'wal_fsync_latency_s_count{tenant="t"} 1' in prom
    finally:
        exp.close()


def test_prometheus_text_equals_the_jax_rendering():
    reg, jreg = MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.inc("wal_bytes_total", 260, tenant="t")
        r.set("maintenance_queue_depth", 2)
        r.observe("ckpt_save_latency_s", 0.3, tenant="t")
    from repro.obs import export as jexport
    assert obs_export.render_prometheus(reg) == \
        jexport.render_prometheus(jreg)


def test_exporter_periodic_thread_stops(tmp_path):
    reg = MetricsRegistry()
    reg.inc("serve_queries_total", 1, tenant="t")
    exp = obs_export.Exporter.for_directory(
        str(tmp_path / "m"), registry=reg,
        tracer=Tracer(sample_rate=0.0, metrics=reg))
    try:
        exp.start(0.01)
        with pytest.raises(RuntimeError):
            exp.start(0.01)
        deadline = time.monotonic() + 30
        while exp.n_flushes < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        thread = exp._thread
        exp.close()
    assert exp.n_flushes >= 3
    assert thread is not None and not thread.is_alive()
    assert (tmp_path / "m" / "metrics.prom").exists()


def test_exporter_unix_socket_sink():
    # an abstract socket (Linux): no file, so no limit from the length of
    # the temporary directory's path
    path = "\0repro-obs-" + uuid.uuid4().hex
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    srv.settimeout(30)
    got = []

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(30)
        with conn:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                got.append(data)
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    reg = MetricsRegistry()
    reg.inc("wal_appends_total", 3, tenant="t")
    try:
        exp = obs_export.Exporter("unix://" + path, registry=reg,
                                  tracer=Tracer(sample_rate=0.0,
                                                metrics=reg))
        exp.flush()
        exp.close()
        t.join(timeout=30)
    finally:
        srv.close()
    assert not t.is_alive()
    lines = [json.loads(x) for x in b"".join(got).decode().splitlines()]
    assert lines and lines[0]["name"] == "wal_appends_total"
    assert lines[0]["value"] == 3


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_export_checker_tool_rejects_drift(tmp_path):
    """The out-of-process checker fails an export of the port's registry
    that holds a name the catalog does not declare."""
    reg = MetricsRegistry()
    reg.inc("serve_queries_total", 5, tenant="t")
    exp = obs_export.Exporter.for_directory(
        str(tmp_path), registry=reg, tracer=Tracer(sample_rate=0.0,
                                                   metrics=reg))
    exp.close()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"kind": "metric", "ts": 1.0,
                            "name": "serve_undocumented_total",
                            "type": "counter", "labels": {"tenant": "t"},
                            "value": 5}) + "\n")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "check_metrics_export.py"),
         str(tmp_path), "--no-spans"],
        capture_output=True, text=True, timeout=120, env=_clean_env())
    assert proc.returncode == 1
    assert "undocumented metric" in proc.stderr


# only a multi-device serve emits it: device wins are attributed per rank
# of a serve mesh, and this run serves one device (the sharded run below
# exports it)
DEVICE_ONLY = {"serve_device_wins_total"}


def test_launcher_metrics_dir_passes_the_export_checker(tmp_path):
    d = tmp_path
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--tenants", "l2-basis", "--n-items", "2048", "--steps",
           "3", "--wal-dir", str(d / "w"), "--snapshot", str(d / "s"),
           "--metrics-dir", str(d / "m"), "--trace-sample", "1.0",
           "--trace-deep"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=_clean_env(), cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[serve] telemetry ->" in run.stdout
    assert (d / "m" / "metrics.prom").exists()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "check_metrics_export.py"),
         str(d / "m")], capture_output=True, text=True, timeout=120,
        env=_clean_env())
    findings = [x.strip()[2:] for x in proc.stderr.splitlines()
                if x.strip().startswith("- ")]
    assert findings == [f"required metric {n} never exported"
                        for n in sorted(DEVICE_ONLY)], proc.stderr
    assert "reconstructed" in proc.stdout
    # every exported line is the port's catalog's
    for line in (d / "m" / "metrics.jsonl").read_text().splitlines():
        o = json.loads(line)
        if o["kind"] == "metric":
            assert o["type"] == CATALOG[o["name"]].type
            assert sorted(o["labels"]) == sorted(CATALOG[o["name"]].labels)


@pytest.mark.parametrize("replicate", ["static:2"])
def test_sharded_launcher_exports_every_required_metric(tmp_path,
                                                        replicate):
    """The launcher serving over a 2-rank CPU mesh with replication
    exports every required metric, ``serve_device_wins_total`` included:
    the export checker finds nothing."""
    d = tmp_path
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--tenants", "l2-basis", "--n-items", "2048", "--steps",
           "3", "--wal-dir", str(d / "w"), "--snapshot", str(d / "s"),
           "--metrics-dir", str(d / "m"), "--trace-sample", "1.0",
           "--trace-deep", "--shard", "2", "--replicate", replicate]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=_clean_env(), cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "shards=2x2 replicas=4/2" in run.stdout, run.stdout[-2000:]
    assert "shard_balance=" in run.stdout
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "check_metrics_export.py"),
         str(d / "m")], capture_output=True, text=True, timeout=120,
        env=_clean_env())
    assert proc.returncode == 0, proc.stderr
    names = {json.loads(x)["name"] for x in
             (d / "m" / "metrics.jsonl").read_text().splitlines()
             if '"metric"' in x}
    assert {"serve_device_wins_total", "serve_device_load_total",
            "router_device_load", "placement_replaced_bytes_total",
            "placement_restack_bytes_total",
            "placement_rebuilds_total"} <= names


# ---------------------------------------------------------------------------
# the same operations through both packages: equal counter deltas
# ---------------------------------------------------------------------------


def _series(reg, tenant):
    """{(name, labels): value or observation count} of ``tenant``'s series
    and of the fault sites' (counters and histograms; gauges are set, not
    accumulated)."""
    out = {}
    for e in reg.collect():
        lab = e["labels"]
        if lab.get("tenant", tenant) != tenant or e["type"] == "gauge":
            continue
        if e["name"] == "serve_stage_latency_s":
            continue       # sampled, and the sample rate is the test's
        key = (e["name"], tuple(sorted(lab.items())))
        out[key] = e["count"] if e["type"] == "histogram" else e["value"]
    return out


def _delta(before, after):
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


def _data(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _corrupt(step_dir):
    p = os.path.join(step_dir, "arrays.npz")
    with open(p, "rb+") as f:
        f.seek(os.path.getsize(p) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _scenario(pkg, root, name, family=None):
    """Inserts, a rejected insert, deletes, two batched queries, a seal, a
    pool compaction, two snapshots (the newer then corrupted), a standby
    poll, an injected fault, a promotion and a recovery."""
    jax_side = pkg == "jax"
    Reg, Spec, Pool, Standby, flt = (
        (JRegistry, JSpec, JPool, JStandby, jfaults) if jax_side else
        (ServableRegistry, ServableSpec, MaintenancePool, WalStandby,
         faults))
    dev = {} if jax_side else {"device": "cpu"}
    wal_dir, ckpt = str(root / "wal"), str(root / "ckpt")
    reg = Reg(wal_dir=wal_dir, fsync_every=2, **dev)
    spec = Spec(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8,
                bucket_capacity=64, segment_capacity=64, insert_chunk=32,
                chunk_sizes=(8, 32))
    sv = reg.register(spec) if jax_side else reg.register(spec,
                                                          family=family)
    g = sv.insert(_data(100, 1))
    sv.delete(g[::5])
    bad = _data(4, 9)
    bad[1, 3] = np.nan
    with pytest.raises(ValueError):
        sv.insert(bad)
    answers = [sv.query(_data(20, 2), 10, 2)]
    sv.maintenance.seal()
    g2 = sv.insert(_data(50, 3))
    pool = Pool(reg, workers=1)
    try:
        job = pool.submit(name, "compact")
        assert pool.wait(job, timeout_s=120)["status"] == "done"
    finally:
        pool.stop(timeout_s=60)
    answers.append(sv.query(_data(8, 4), 10, 2))
    reg.snapshot(ckpt, step=1)
    sv.insert(_data(30, 5))
    sv.delete(g2[:7])
    reg.snapshot(ckpt, step=2)
    _corrupt(os.path.join(ckpt, name, "step_0000000002"))
    sb = Standby(wal_dir, **dev)
    try:
        sb.poll_once()
    finally:
        sb.stop()
    flt.install(flt.FaultPlan(flt.FaultSpec("wal.append", 1, "raise")))
    try:
        with pytest.raises(Exception) as err:
            sv.insert(_data(4, 6))
        assert type(err.value).__name__ == "InjectedFault"
    finally:
        flt.clear()
    promoted = sb.promote()
    assert promoted[name]["truncated"]
    rec = Reg(**dev).recover(ckpt_root=ckpt, wal_dir=wal_dir)
    assert rec[name]["restored_step"] == 1 and len(
        rec[name]["corrupt_steps"]) == 1
    return sv, answers


def test_counter_deltas_equal_the_jax_package(tmp_path):
    name = _tenant()
    jreg, reg = jmetrics.registry(), obs_metrics.registry()
    jb, b = _series(jreg, name), _series(reg, name)
    jsv, janswers = _scenario("jax", tmp_path / "jax", name)
    fam = convert.family_from_numpy(*(np.asarray(a) for a in
                                      jsv.index.family), device="cpu")
    _, answers = _scenario("torch", tmp_path / "torch", name, family=fam)
    for (g, d), (jg, jd) in zip(answers, janswers):
        np.testing.assert_array_equal(g, np.asarray(jg))
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-6, atol=1e-6)
    jd_, d_ = _delta(jb, _series(jreg, name)), _delta(b, _series(reg, name))
    assert d_ == jd_
    names = {k[0] for k in d_}
    assert {"serve_queries_total", "serve_inserts_total",
            "serve_deletes_total", "serve_rejected_inserts_total",
            "serve_batches_total", "serve_batch_rows_real_total",
            "serve_batch_rows_padded_total", "serve_query_latency_s",
            "serve_queue_wait_s", "serve_segment_wins_total",
            "wal_appends_total", "wal_bytes_total", "wal_fsyncs_total",
            "wal_append_latency_s", "wal_fsync_latency_s",
            "ckpt_saves_total", "ckpt_save_latency_s", "ckpt_restores_total",
            "ckpt_restore_latency_s", "ckpt_corrupt_total",
            "recovery_replayed_records_total", "recovery_restores_total",
            "faults_fired_total", "maintenance_jobs_total",
            "maintenance_job_latency_s", "standby_replayed_records_total",
            "standby_promotions_total"} <= names, sorted(names)
    wal_bytes = os.path.getsize(tmp_path / "torch" / "wal" / f"{name}.wal")
    # a fault-cut append counts nothing, and the promotion cut its torn
    # header off the file
    assert d_[("wal_bytes_total", (("tenant", name),))] == wal_bytes


@pytest.mark.parametrize("sparse", [False, True])
def test_segment_wins_follow_the_locator(sparse):
    """Wins per segment from the gid -> segment array equal a count
    through the locator, after inserts, a seal, deletes and a compaction;
    with gids too sparse for an array (a caller's own) the locator
    answers."""
    _, _, fam = _family(7)
    cfg = IndexConfig(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
                      bucket_capacity=32, r=4.0)
    idx = SegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                         family=fam, device="cpu", tenant=_tenant())
    rng = np.random.default_rng(7)
    base = 1 << 28 if sparse else 0
    idx.insert(rng.normal(size=(150, N_DIMS)).astype(np.float32),
               gids=base + np.arange(150) * (1000 if sparse else 1))
    idx.maintenance.seal()
    idx.insert(rng.normal(size=(90, N_DIMS)).astype(np.float32))
    idx.delete(idx.live_items()[1].numpy()[::4])
    for step in range(2):
        q = rng.normal(size=(32, N_DIMS)).astype(np.float32)
        g = idx.query(q, 10, n_probes=4)[0].numpy()
        want = np.zeros(len(idx.segments), np.int64)
        for gid in g[g >= 0].tolist():
            want[idx._locator[gid][0]] += 1
        np.testing.assert_array_equal(idx.segment_wins(g), want)
        assert (idx._gid_seg is None) == sparse
        idx.maintenance.compact()
