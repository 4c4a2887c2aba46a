"""The port's compaction and maintenance plane against the JAX package's.

Mirrors ``tests/test_maintenance.py``,
``tests/test_serve.py::test_parity_survives_compaction`` and
``tests/test_quantized_serve.py::test_quantized_delete_compact_and_exact_live_items``
on the CPU.  One numpy-drawn family goes into both packages, which see the
same inserts, deletes and compactions (the JAX side through
``maintenance.compact()``); afterwards:

* the port's gids equal the JAX package's and its distances are allclose
  (rtol 1e-5, atol 1e-6: the two stacks' plain versions sum in other
  orders), at fp32, int8 and bf16, 1 and 4 probes, in a config with room
  in every bucket and in one whose buckets overflow;
* the port's stacked query equals its own per-segment fan-out
  (``_query_fanout``) bit for bit, and its sealed segments are views of
  the slots of the stack it adopted (quiet swap) or rebuilt (splice);
* freeze / build / swap driven by hand with writes between the phases --
  a splice whose post-freeze inserts double the old stack, and a delete of
  a frozen gid after that restack -- answer as an index compacted inline
  at the freeze point, bit for bit;
* ledgered deletes re-apply idempotently; compacting to an empty index;
* the ``MaintenancePool``'s lifecycle, and a background compaction under a
  streaming query thread (every answer equal, none torn);
* launch counts from several threads are not lost.

Every thread join and ``pool.wait`` has a timeout and every pool is
stopped in ``finally``.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import (MaintenancePool, SegmentedIndex,  # noqa: E402
                               ServableRegistry, ServableSpec)
from repro_torch.serve import maintenance as maint_mod  # noqa: E402

N_DIMS = 16
PRECISIONS = ("fp32", "int8", "bf16")
# "roomy": no bucket overflows at these sizes, so an answer does not depend
# on which segment holds an item; "overflow": 16 buckets x 4 slots, most
# items are dropped from some table, and which ones depends on the order
CFG_KW = {
    "roomy": dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
                  bucket_capacity=64, r=2.0),
    "overflow": dict(n_dims=N_DIMS, n_tables=4, n_hashes=2, log2_buckets=4,
                     bucket_capacity=4, r=2.0),
}
CAP, CHUNK = 64, 32


def _family(kind="roomy", seed=5):
    kw = CFG_KW[kind]
    lk = kw["n_tables"] * kw["n_hashes"]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_DIMS, lk)).astype(np.float32),
            rng.uniform(size=(lk,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(kw["n_tables"],
                                                kw["n_hashes"])) | 1
             ).astype(np.uint32))


def _port(precision="fp32", kind="roomy"):
    return SegmentedIndex(tidx.IndexConfig(**CFG_KW[kind]),
                          segment_capacity=CAP, insert_chunk=CHUNK,
                          device="cpu", precision=precision,
                          family=convert.family_from_numpy(*_family(kind),
                                                           device="cpu"))


def _jax(precision="fp32", kind="roomy"):
    return JSegmentedIndex(jidx.IndexConfig(**CFG_KW[kind]),
                           segment_capacity=CAP, insert_chunk=CHUNK,
                           precision=precision,
                           family=tuple(jnp.asarray(a)
                                        for a in _family(kind)))


def _data(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _queries():
    return np.concatenate([_data(7, seed=9, scale=0.9), _data(3, seed=1)])


def _answer(index, q, n_probes=4):
    g, d = index.query(q, 10, n_probes=n_probes)
    return np.asarray(g), np.asarray(d)


def _assert_same_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


def _assert_matches_jax(ts, js, q, n_probes=4):
    gt, dt = _answer(ts, q, n_probes)
    gj, dj = _answer(js, q, n_probes)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    assert ts.n_live == js.n_live and ts.n_items == js.n_items


def _assert_stacked_equals_fanout(ts, q, n_probes=4):
    got = ts.query(q, 10, n_probes=n_probes)
    want = ts._query_fanout(q, 10, n_probes=n_probes)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def _assert_views_and_locator(ts):
    """Sealed segment i is slot i of the index's stack, its tensors views
    of that slot; the locator points at each gid's slot."""
    st = ts._stack
    sealed = ts.segments[:-1]
    assert st.segments == sealed and ts.layout()["n_sealed"] == len(sealed)
    for slot, seg in enumerate(sealed):
        assert seg.sealed and seg.n_items > 0
        assert seg.state.db.data_ptr() == st.db[slot].data_ptr()
        assert seg.state.table.data_ptr() == st.table[slot].data_ptr()
        assert seg.gids.data_ptr() == st.gids[slot].data_ptr()
        assert seg.live.data_ptr() == st.live[slot].data_ptr()
        if st.quantized:
            assert seg.scale.data_ptr() == st.scale[slot].data_ptr()
            assert np.shares_memory(seg.pool, st.pool)
    assert not ts.delta.sealed
    for gid, (si, slot) in ts._locator.items():
        assert int(ts.segments[si].gids[slot]) == gid


def _both(fn, ts, js):
    """Apply one data-plane step to both packages; their results agree."""
    a, b = fn(ts), fn(js)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return np.asarray(a)


def _churn(index, seed, n=40, every=6):
    g = index.insert(_data(n, seed=seed))
    index.delete(g[::every])
    return g


# -- the handle and the deprecation shims -------------------------------------


def test_maintenance_handle_and_shims():
    ts = _port()
    g = ts.insert(_data(150, seed=1))
    ts.delete(g[::5])
    q = _queries()
    want = _answer(ts, q)
    ts.maintenance.seal()
    assert ts.delta.n_items == 0
    assert ts.maintenance.compact() == len(ts.segments)
    _assert_same_bits(_answer(ts, q), want)
    with pytest.warns(DeprecationWarning):
        ts.seal()
    with pytest.warns(DeprecationWarning):
        ts.compact()
    _assert_same_bits(_answer(ts, q), want)
    assert ts.maintenance is ts.maintenance


def test_servable_handle_and_compact_shim():
    reg = ServableRegistry(device="cpu")
    sv = reg.register(_spec())
    sv.insert(_data(100, seed=1))
    assert sv.maintenance.seal() == len(sv.index.segments) == 3
    with pytest.warns(DeprecationWarning):
        assert sv.compact() == len(sv.index.segments)


def test_pool_kinds_leave_out_set_replication():
    # the JAX package's three kinds: set_replication places segments
    # across a serve mesh
    from repro.serve import maintenance as jmaint
    assert maint_mod.KINDS == jmaint.KINDS == ("seal", "compact",
                                                "set_replication")


# -- after a compaction, against the JAX package ------------------------------


@pytest.mark.parametrize("kind", sorted(CFG_KW))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n_probes", [1, 4])
def test_compacted_index_equals_jax(kind, precision, n_probes):
    ts, js = _port(precision, kind), _jax(precision, kind)
    q = _queries()
    emb = _data(420, seed=1)
    _both(lambda s: s.insert(emb), ts, js)
    dead = np.concatenate([np.arange(0, 420, 3), np.arange(64, 128)])
    assert ts.delete(dead) == js.delete(dead)
    assert ts.maintenance.compact() == js.maintenance.compact()
    assert ts.n_items == ts.n_live == 420 - np.unique(dead).size
    _assert_matches_jax(ts, js, q, n_probes)
    _assert_stacked_equals_fanout(ts, q, n_probes)
    _assert_views_and_locator(ts)
    # a second round: writes on the compacted index, compacted again
    _both(lambda s: s.insert(_data(150, seed=2)), ts, js)
    assert ts.delete(np.arange(300, 600, 4)) == js.delete(
        np.arange(300, 600, 4))
    assert ts.maintenance.compact() == js.maintenance.compact()
    _assert_matches_jax(ts, js, q, n_probes)
    _assert_stacked_equals_fanout(ts, q, n_probes)
    _assert_views_and_locator(ts)
    assert [s.n_items for s in ts.segments] == [s.n_items
                                                for s in js.segments]


def test_parity_survives_compaction():
    """``test_serve.py::test_parity_survives_compaction``: with room in
    every bucket the answer is unchanged, the tombstones are gone and the
    segments keep their capacity."""
    ts, js = _port(), _jax()
    gids = _both(lambda s: s.insert(_data(300, seed=1)), ts, js)
    assert ts.delete(gids[100:200]) == js.delete(gids[100:200]) == 100
    q = _queries()
    before = _answer(ts, q)
    assert ts.maintenance.compact() == js.maintenance.compact()
    assert ts.n_live == ts.n_items == 200
    _assert_same_bits(_answer(ts, q), before)
    _assert_matches_jax(ts, js, q)
    assert all(s.capacity == CAP for s in ts.segments)
    # 200 live: three full segments sealed, the fourth (8 items) the delta
    assert [s.n_items for s in ts.segments] == [64, 64, 64, 8]


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quantized_compaction_keeps_exact_rows(precision):
    """The shadow reads the fp32 survivor pool, never decoded codes: every
    kept item's row is bit-exact across the compaction."""
    ts, js = _port(precision), _jax(precision)
    _both(lambda s: s.insert(_data(400, seed=3)), ts, js)
    emb0, gid0 = (t.numpy() for t in ts.live_items())
    assert ts.delete(gid0[:50]) == js.delete(gid0[:50]) == 50
    ts.maintenance.compact()
    js.maintenance.compact()
    emb1, gid1 = (t.numpy() for t in ts.live_items())
    keep = np.isin(gid0, gid1)
    assert keep.sum() == 350 and np.array_equal(gid1, np.sort(gid1))
    np.testing.assert_array_equal(emb0[keep][np.argsort(gid0[keep])],
                                  emb1)
    jemb1, jgid1 = js.live_items()
    np.testing.assert_array_equal(jgid1, gid1)
    np.testing.assert_array_equal(jemb1, emb1)
    g, _ = _answer(ts, _queries())
    assert not np.isin(g, gid0[:50]).any()
    _assert_matches_jax(ts, js, _queries())


@pytest.mark.parametrize("precision", PRECISIONS)
def test_compacting_to_an_empty_index(precision):
    ts, js = _port(precision), _jax(precision)
    g = _both(lambda s: s.insert(_data(150, seed=4)), ts, js)
    assert ts.delete(g) == js.delete(g) == 150
    assert ts.maintenance.compact() == js.maintenance.compact() == 1
    assert ts.n_items == ts.n_live == 0
    assert ts.layout()["n_sealed"] == 0 and ts.layout()["s_cap"] == 0
    assert ts._locator == {}
    gt, dt = _answer(ts, _queries())
    assert (gt == -1).all() and np.isinf(dt).all()
    _assert_matches_jax(ts, js, _queries())
    # the empty index takes writes again, gids continuing where they were
    g2 = _both(lambda s: s.insert(_data(70, seed=5)), ts, js)
    assert g2[0] == 150
    _assert_matches_jax(ts, js, _queries())
    _assert_stacked_equals_fanout(ts, _queries())


# -- the phases by hand --------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mutate_during_build", [False, True],
                         ids=["quiet", "concurrent-writes"])
def test_compact_phase_interleaving_parity(mutate_during_build, precision):
    """Freeze, build and swap by hand with writes between the phases: the
    answers equal, bit for bit, an index that saw the same operations with
    an inline compaction at the freeze point, and the JAX package's index
    driven through the same phases."""
    ts, oracle, js = _port(precision), _port(precision), _jax(precision)
    for seed in (1, 2, 3):
        for index in (ts, oracle, js):
            _churn(index, seed)
    q = _queries()

    frozen_n, frozen = ts._compact_freeze()
    jfrozen_n, jfrozen = js._compact_freeze()
    assert frozen_n == jfrozen_n
    oracle.maintenance.compact()
    if mutate_during_build:
        # writes after the freeze land in new segments and survive the swap
        g4 = _churn(ts, 4)
        np.testing.assert_array_equal(g4, _churn(oracle, 4))
        np.testing.assert_array_equal(g4, _churn(js, 4))
        # a delete of a frozen item goes to the ledger
        victim = int(frozen[0].gids[frozen[0].live][0])
        for index in (ts, oracle, js):
            assert index.delete([victim]) == 1
        assert victim in ts._compact_deletes
        # reads between the phases see the state before the swap
        assert _answer(ts, q)[0].shape == (10, 10)
    ts._compact_swap(frozen_n, ts._compact_build(frozen))
    js._compact_swap(jfrozen_n, js._compact_build(jfrozen))
    assert ts._compact_deletes is None

    _assert_same_bits(_answer(ts, q), _answer(oracle, q))
    _assert_matches_jax(ts, js, q)
    _assert_stacked_equals_fanout(ts, q)
    _assert_views_and_locator(ts)
    assert ts.n_live == oracle.n_live


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("when", ["before_build", "after_build"])
def test_splice_across_a_doubling_of_the_old_stack(when, precision):
    """Post-freeze inserts seal two segments, the second of which finds
    the old stack full and doubles it (rebinding every frozen segment's
    views), and a frozen gid is deleted after that restack -- before the
    build reads the frozen segments, or after it.  The swap splices the
    new sealed segments behind the shadow's, restacks them in order and
    re-applies the delete."""
    ts, oracle, js = _port(precision), _port(precision), _jax(precision)
    emb = _data(3 * CAP + 10, seed=1)
    for index in (ts, oracle, js):
        index.insert(emb)
        index.delete(np.arange(0, 3 * CAP + 10, 4))
    frozen_n, frozen = ts._compact_freeze()
    jfrozen_n, jfrozen = js._compact_freeze()
    oracle.maintenance.compact()
    assert frozen_n == 4 and ts.layout() == dict(ts.layout(), n_sealed=4,
                                                 s_cap=4)
    ptr = frozen[0].live.data_ptr()
    shadow = jshadow = None
    if when == "after_build":
        shadow, jshadow = ts._compact_build(frozen), js._compact_build(jfrozen)

    more = _data(2 * CAP + 5, seed=2)
    for index in (ts, oracle, js):
        index.insert(more)
    assert ts.layout()["n_sealed"] == 6 and ts.layout()["s_cap"] == 8
    assert frozen[0].live.data_ptr() != ptr          # the views were rebound
    victim = int(frozen[1].gids[5])
    for index in (ts, oracle, js):
        assert index.delete([victim, 3 * CAP + 12]) == 2
    if shadow is None:
        shadow, jshadow = ts._compact_build(frozen), js._compact_build(jfrozen)
    n_seg = ts._compact_swap(frozen_n, shadow)
    js._compact_swap(jfrozen_n, jshadow)

    assert n_seg == len(ts.segments) == len(js.segments)
    q = _queries()
    _assert_same_bits(_answer(ts, q), _answer(oracle, q))
    _assert_matches_jax(ts, js, q)
    _assert_stacked_equals_fanout(ts, q)
    _assert_views_and_locator(ts)
    assert ts.delete([victim]) == 0
    assert ts.n_live == oracle.n_live == js.n_live
    # the shadow's stack, rebuilt over 3 re-packed + 2 spliced segments
    assert ts._stack is shadow._stack and ts.layout()["n_sealed"] == 5


def test_compact_swap_reapplies_ledgered_deletes_idempotently():
    """A gid deleted during the build must not be counted twice."""
    ts = _port()
    g = ts.insert(_data(100, seed=1))
    frozen_n, frozen = ts._compact_freeze()
    assert ts.delete([int(g[10]), int(g[10])]) == 1
    n_live_mid = ts.n_live
    ts._compact_swap(frozen_n, ts._compact_build(frozen))
    assert ts.n_live == n_live_mid == 99
    assert ts.delete([int(g[10])]) == 0
    assert int(g[10]) not in ts._locator


def test_failed_build_closes_the_ledger(monkeypatch):
    ts = _port()
    ts.insert(_data(100, seed=1))

    def broken(frozen):
        raise RuntimeError("build failed")
    monkeypatch.setattr(ts, "_compact_build", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        ts.maintenance.compact()
    assert ts._compact_deletes is None
    assert ts.delete([3]) == 1


# -- the pool ------------------------------------------------------------------


def _spec(name="t", precision="fp32"):
    return ServableSpec(name=name, n_dims=N_DIMS, p=2.0, r=2.0,
                        embedder="basis", log2_buckets=8, bucket_capacity=64,
                        segment_capacity=CAP, insert_chunk=CHUNK,
                        chunk_sizes=(8, 32), precision=precision)


def test_pool_job_lifecycle_and_isolation():
    reg = ServableRegistry(device="cpu")
    reg.register(_spec())
    reg.get("t").insert(_data(80, seed=1))
    pool = MaintenancePool(reg, workers=1)
    try:
        st = pool.wait(pool.submit("t", "seal"), timeout_s=60.0)
        assert st["status"] == "done" and st["result"]["n_segments"] == 3
        reg.get("t").delete(np.arange(0, 80, 3))
        st = pool.wait(pool.submit("t", "compact"), timeout_s=60.0)
        assert st["status"] == "done"
        assert st["result"]["n_live"] == reg.get("t").index.n_live == 53
        assert st["result"]["n_segments"] == 1
        # a job for a missing tenant fails with its error; the worker goes on
        bad = pool.wait(pool.submit("ghost", "compact"), timeout_s=60.0)
        assert bad["status"] == "failed" and "ghost" in bad["error"]
        assert "KeyError" in bad["traceback"]
        again = pool.wait(pool.submit("t", "seal"), timeout_s=60.0)
        assert again["status"] == "done"
        rep = pool.wait(pool.submit("t", "set_replication",
                                    replication=[2, 1]), timeout_s=60.0)
        assert rep["status"] == "done"
        assert rep["result"] == {"replication": [2, 1]}
        assert reg.get("t").index.replication() == (2, 1)
        with pytest.raises(ValueError):
            pool.submit("t", "defrag")
        assert pool.status("mj-999") is None
        with pytest.raises(KeyError):
            pool.wait("mj-999", timeout_s=1.0)
    finally:
        pool.stop(timeout_s=60.0)
    assert not any(t.is_alive() for t in pool._threads)
    with pytest.raises(RuntimeError, match="stopped"):
        pool.submit("t", "seal")
    pool.stop()                                    # idempotent


@pytest.mark.parametrize("precision", PRECISIONS)
def test_background_compaction_is_invisible_to_queries(precision):
    """Pool workers compact while this thread streams queries: with room
    in every bucket the states before and after a swap answer alike, so
    every answer must equal the one taken before (none torn)."""
    reg = ServableRegistry(device="cpu")
    sv = reg.register(_spec(precision=precision))
    for seed in (1, 2, 3, 4):
        g = sv.index.insert(_data(60, seed=seed))
        sv.index.delete(g[::7])
    q = _queries()
    want = _answer(sv.index, q)
    pool = MaintenancePool(reg, workers=2)
    stop = threading.Event()
    seen, failures = [], []

    def stream():
        while not stop.is_set():
            got = _answer(sv.index, q)
            seen.append(len(sv.index.segments))
            if not (np.array_equal(got[0], want[0]) and np.array_equal(
                    got[1].view(np.int32), want[1].view(np.int32))):
                failures.append(got)
                return

    t = threading.Thread(target=stream)
    t.start()
    try:
        jobs = [pool.submit("t", "compact") for _ in range(3)]
        for j in jobs:
            assert pool.wait(j, timeout_s=120.0)["status"] == "done"
    finally:
        stop.set()
        t.join(timeout=60.0)
        pool.stop(timeout_s=60.0)
    assert not t.is_alive()
    assert not failures, "an answer differed during the compaction"
    assert seen, "no query ran during the compactions"
    _assert_same_bits(_answer(sv.index, q), want)
    _assert_stacked_equals_fanout(sv.index, q)
    assert sv.index.n_items == sv.index.n_live


# -- launch counts from threads ------------------------------------------------


def test_launch_counts_from_threads_are_not_lost():
    """``count_launch`` is called by the query thread and a maintenance
    worker at once; with a tiny switch interval an unguarded ``+= 1``
    drops counts."""
    dispatch.reset_launches()
    n_threads, n_each = 4, 20000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda name=name: [dispatch.count_launch(name)
                                      for _ in range(n_each)])
            for name in ("hash_mm", "hash_mm", "merge", "merge")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert dispatch.launches["hash_mm"] == 2 * n_each
    assert dispatch.launches["merge"] == (n_threads - 2) * n_each
    dispatch.reset_launches()
    assert not any(dispatch.launches.values())


# -- the launcher ----------------------------------------------------------------


def test_launcher_compacts_past_compact_at():
    """At 90% deletes a step the tombstone share passes 0.3 within a few
    steps; the default 5% never reaches it."""
    rep = tserve.run(device="cpu", tenants=("l2-basis",), n_items=0,
                     steps=12, delete_frac=0.9, compact_at=0.3,
                     recall_probe_size=8, self_hit_probes=16,
                     log=lambda *a: None)["l2-basis"]
    assert rep["compactions"] > 0
    assert rep["self_hit_rate"] >= 0.95
    # deletes start once more than 4 x 57 items are in: from the 4th step
    assert rep["n_live"] == 12 * 64 - 9 * 57
    rep = tserve.run(device="cpu", tenants=("l2-basis",), n_items=0,
                     steps=6, recall_probe_size=8, self_hit_probes=16,
                     log=lambda *a: None)["l2-basis"]
    assert rep["compactions"] == 0
