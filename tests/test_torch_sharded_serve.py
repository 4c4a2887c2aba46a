"""The port's sharded serve path on the CPU, against its own stacked query
and the JAX package.

Mirrors ``tests/test_sharded_serve.py`` case by case.  The port serves a
mesh from one process, as the JAX package does, so the JAX tests'
8-device subprocess cases run here in process on an 8-rank CPU mesh
(``launch.mesh.make_serve_mesh(8, device="cpu")``):

* ``SegmentedIndex.shard(mesh)`` answers bit for bit as the unsharded
  (stacked) query -- gids equal, distance bits equal -- on 1-, 3- and
  8-rank meshes, at fp32 and int8, p in {1, 2}, 1 and 4 probes, with
  tombstones on remote ranks, a segment count no mesh divides, an empty
  and a delta-only index, mutations after ``shard`` and a compaction while
  sharded, and the Wasserstein tenant;
* the sharded answer against the JAX package's unsharded index on one
  injected family: gids equal where the distances are distinct, distances
  allclose (rtol 1e-5, atol 1e-6, as ``tests/test_torch_stacked.py``);
* ``round_robin`` and ``layout_dict`` equal the JAX functions' (pure
  host functions: a ``ServeMesh`` stands in for a JAX mesh);
* delta-only mutations re-take only the delta, a sealed delete diffs the
  mask row, and a seal moves O(one segment) bytes
  (``tests/test_maintenance.py::test_seal_replaces_only_the_new_segment_bytes``);
* the registry threads the mesh through register, snapshot and restore,
  also onto a mesh of another size or none, and ``recover`` and a
  ``WalStandby`` place a logged tenant onto their own mesh;
* fan-out telemetry: wins per segment and per rank.

Every tenant name is unique to its test and every registry is the test's
own; nothing here configures the process tracer.
"""

import dataclasses
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro.sharding import placement as jplacement  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.launch.mesh import ServeMesh, make_serve_mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import (SegmentedIndex, ServableRegistry,  # noqa: E402
                               ServableSpec, ServingStats)
from repro_torch.sharding import placement  # noqa: E402

N_DIMS = 16
CFG_KW = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=2.0)


def _cfg(p=2.0):
    return tidx.IndexConfig(**CFG_KW, p=p)


def _data(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _family(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_DIMS, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.uint32))


def _mesh(n):
    return make_serve_mesh(n, device="cpu")


def _tenant():
    return "shard-" + uuid.uuid4().hex[:10]


def _index(p=2.0, precision="fp32", capacity=64, **kw):
    return SegmentedIndex(_cfg(p), segment_capacity=capacity,
                          insert_chunk=min(capacity, 64), device="cpu",
                          precision=precision, tenant=_tenant(),
                          family=convert.family_from_numpy(*_family(),
                                                           device="cpu"),
                          **kw)


def _bits(ans):
    g, d = ans
    return g.numpy(), d.numpy().view(np.uint32)


def _assert_bit_equal(got, want):
    (gg, gd), (wg, wd) = _bits(got), _bits(want)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(gd, wd)


# -- one rank: the degenerate mesh --------------------------------------------


def test_one_device_mesh_parity():
    si = _index(capacity=128)
    gids = si.insert(_data(300, seed=1))
    si.delete(gids[::7])
    q = _data(9, seed=2, scale=0.9)
    want = si.query(q, 10, n_probes=4)
    si.shard(_mesh(1))
    _assert_bit_equal(si.query(q, 10, n_probes=4), want)
    lay = si.shard_layout()
    assert lay["n_dev"] == 1 and lay["n_sealed"] == 2
    assert lay["assignment"] == [[0, 1]]


def test_mutation_invalidates_placement():
    si = _index(capacity=128)
    gids = si.insert(_data(200, seed=1))
    si.shard(_mesh(3))
    q = _data(5, seed=2, scale=0.9)
    si.query(q, 10, n_probes=4)                  # builds a placement
    si.insert(_data(50, seed=4))                 # every mutation path
    si.delete(gids[:40])
    si.maintenance.compact()
    got = si.query(q, 10, n_probes=4)
    si.unshard()
    _assert_bit_equal(got, si.query(q, 10, n_probes=4))


def test_delta_only_mutations_skip_sealed_restack():
    """Delta-only writes re-take the delta and leave the rank blocks; a
    delete in a sealed segment rewrites that segment's live row alone."""
    si = _index(capacity=128)
    gids = si.insert(_data(300, seed=1))
    si.shard(_mesh(1))
    q = _data(5, seed=2, scale=0.9)
    si.query(q, 10, n_probes=4)
    pl0 = si._placement
    g2 = si.insert(_data(10, seed=4))            # delta-only insert
    si.delete(g2[:3])                            # delta-only delete
    si.query(q, 10, n_probes=4)
    assert si._placement.blocks is pl0.blocks
    assert si._placement.version == pl0.version

    si.delete(gids[1:2])                         # sealed: a live-row diff
    si.query(q, 10, n_probes=4)
    pl1 = si._placement
    assert pl1 is not pl0 and pl1.diffed
    assert pl1.replaced_bytes == si.segments[0].live.nbytes
    assert pl1.replaced_bytes < pl1.sealed_bytes

    si.unshard()
    si.shard(_mesh(1))                           # a clean rebuild
    got = si.query(q, 10, n_probes=4)
    assert not si._placement.diffed
    si.unshard()
    _assert_bit_equal(got, si.query(q, 10, n_probes=4))


def test_sharded_empty_and_delta_only():
    si = _index(capacity=128)
    si.shard(_mesh(8))
    ids, dists = si.query(_data(4, seed=7), 5)
    assert (ids == -1).all() and torch.isinf(dists).all()
    si.insert(_data(10, seed=8))                 # only the delta
    assert si.shard_layout()["n_sealed"] == 0
    ids, _ = si.query(_data(10, seed=8), 1)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(10))


def test_shard_rejects_unknown_axis():
    si = _index(capacity=128)
    with pytest.raises(ValueError, match="serve"):
        si.shard(ServeMesh(devices=(torch.device("cpu"),),
                           axis_names=("data",)), axis="serve")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_round_robin_assignment(n_dev):
    assert placement.round_robin(7, 3) == [[0, 3, 6], [1, 4], [2, 5]]
    for n in (0, 1, 2, 7, 17):
        assert placement.round_robin(n, n_dev) == \
            jplacement.round_robin(n, n_dev)
    mesh = _mesh(n_dev)
    # the JAX function reads only a mesh's shape and axis names
    for n, rep in ((0, None), (7, None), (7, 2), (5, [3, 1, 2])):
        assert placement.layout_dict(mesh, "serve", n, replication=rep) \
            == jplacement.layout_dict(mesh, "serve", n, replication=rep)


# -- many ranks: bit-equal to the stacked query --------------------------------


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("n_probes", [1, 4])
def test_multi_device_parity_edge_cases(precision, p, n_probes):
    """3- and 8-rank meshes (7 sealed segments: padding on both), deletes
    on every rank; the wins per rank sum to the wins per segment."""
    calls = []
    si = _index(p=p, precision=precision,
                on_fanout=lambda *a: calls.append(a))
    gids = si.insert(_data(450, seed=1))         # 7 sealed + the delta
    si.delete(gids[::7])
    q = _data(9, seed=2, scale=0.9)
    want = si.query(q, 10, n_probes=n_probes)
    for n_dev in (3, 8):
        si.shard(_mesh(n_dev))
        assert si.shard_layout()["n_sealed"] == 7
        got = si.query(q, 10, n_probes=n_probes)
        _assert_bit_equal(got, want)
        si.fanout_telemetry(got[0].numpy())
        seg_w, dev_w = calls[-1]
        assert len(dev_w) == n_dev
        assert sum(dev_w) == sum(seg_w) > 0
        si.unshard()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_sharded_query_equals_jax_unsharded(precision):
    """The port on 8 CPU ranks against the JAX package's unsharded index,
    one family in both: gids equal where the distances are distinct,
    distances allclose."""
    cfg = jidx.IndexConfig(**CFG_KW)
    js = JSegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                         precision=precision,
                         family=tuple(jnp.asarray(a) for a in _family()))
    ts = _index(precision=precision)
    emb = _data(460, seed=11)
    np.testing.assert_array_equal(ts.insert(emb), js.insert(emb))
    dead = np.concatenate([np.arange(0, 460, 6), np.arange(64, 128)])
    assert js.delete(dead) == ts.delete(dead)
    ts.shard(_mesh(8))
    q = _data(12, seed=12, scale=0.9)
    for n_probes in (1, 4):
        jg, jd = (np.asarray(a) for a in js.query(q, 10, n_probes=n_probes))
        tg, td = (t.numpy() for t in ts.query(q, 10, n_probes=n_probes))
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
        for r in range(jg.shape[0]):
            with np.errstate(invalid="ignore"):  # inf - inf past the hits
                step = np.diff(jd[r]) > 0
            distinct = np.isfinite(jd[r]) & np.r_[True, step] & \
                np.r_[step, True]
            np.testing.assert_array_equal(tg[r][distinct], jg[r][distinct])
        assert (tg >= 0).any()


def test_multi_device_compact_while_sharded():
    """A compaction under a 4-rank mesh: answers unchanged, equal to the
    unsharded query, whole remote segments' tombstones gone."""
    si = _index()
    gids = si.insert(_data(450, seed=1))
    si.delete(gids[100:300])                     # whole remote segments die
    si.shard(_mesh(4))
    q = _data(6, seed=3, scale=0.9)
    before = si.query(q, 10, n_probes=4)
    si.maintenance.compact()
    assert si.n_items == 250
    after = si.query(q, 10, n_probes=4)
    _assert_bit_equal(after, before)
    si.unshard()
    _assert_bit_equal(after, si.query(q, 10, n_probes=4))


def test_seal_replaces_only_the_new_segment_bytes():
    """With stripe headroom held, sealing one more segment moves at most
    two segments' bytes (the new slot and the re-taken mask rows), far
    under a restack's."""
    si = _index()
    m = obs_metrics.registry()
    si.insert(_data(300, seed=1))                # several sealed + delta
    si.shard(_mesh(1))
    q = _data(5, seed=2, scale=0.9)
    si.query(q, 10, n_probes=4)
    seg = si.segments[0]
    one_seg = (seg.state.table.nbytes + seg.state.db.nbytes
               + seg.gids.nbytes + seg.live.nbytes)
    moved = []
    for i in range(3):                           # through a doubling
        before = m.value("placement_replaced_bytes_total",
                         tenant=si.tenant) or 0
        si.insert(_data(64, seed=4 + i))         # one more segment
        si.maintenance.seal()
        si.refresh_placement()
        pl = si._placement
        after = m.value("placement_replaced_bytes_total", tenant=si.tenant)
        if pl.diffed:
            moved.append(after - before)
            assert after - before <= 2 * one_seg, (after - before, one_seg)
            assert after - before < pl.sealed_bytes
        else:                                    # the O(log n) restack
            assert pl.per_dev >= 2
    assert moved
    got = si.query(q, 10, n_probes=4)
    si.unshard()
    _assert_bit_equal(got, si.query(q, 10, n_probes=4))


# -- the registry --------------------------------------------------------------


def _spec(name, **kw):
    base = dict(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8,
                bucket_capacity=64, segment_capacity=64, insert_chunk=32,
                chunk_sizes=(8, 32), shard_axis="serve")
    base.update(kw)
    return ServableSpec(**base)


def test_registry_shard_axis_and_snapshot_restore(tmp_path):
    """The spec's shard axis threads the mesh through register and
    restore; the snapshot records the layout, and a restore re-places onto
    the restoring registry's mesh, of another size or none, answering the
    same."""
    name = _tenant()
    reg = ServableRegistry(device="cpu", mesh=_mesh(8))
    sv = reg.register(_spec(name))
    gids = sv.insert(_data(600, seed=14))
    sv.delete(gids[::3])
    q = _data(5, seed=15, scale=0.9)
    want = sv.index.query(q, 10, n_probes=4)
    lay = reg.report()[name]["shard_layout"]
    assert (lay["axis"], lay["n_dev"], lay["n_sealed"]) == ("serve", 8, 9)
    reg.snapshot(str(tmp_path), step=1)
    from repro_torch.checkpoint import checkpoint as ckpt
    extra = ckpt.load_extra(str(tmp_path / name), 1)
    assert extra["shard_layout"] == lay
    for mesh, n_dev in ((_mesh(8), 8), (_mesh(3), 3), (None, None)):
        reg2 = ServableRegistry(device="cpu", mesh=mesh)
        assert reg2.restore(str(tmp_path)) == [name]
        idx = reg2.get(name).index
        lay2 = idx.shard_layout()
        assert (lay2 is None) == (n_dev is None)
        if lay2 is not None:
            assert (lay2["n_dev"], lay2["n_sealed"]) == (n_dev, 9)
        _assert_bit_equal(idx.query(q, 10, n_probes=4), want)
    # a spec without a shard axis stays on the device beside sharded ones
    plain = reg.register(dataclasses.replace(_spec(_tenant()),
                                             shard_axis=None))
    assert plain.index.shard_layout() is None


def test_wasserstein_tenant_sharded_parity():
    """The distribution tenant is placed as a function tenant with the same
    segment history, and answers bit for bit as its unsharded self."""
    reg = ServableRegistry(device="cpu", mesh=_mesh(8))
    names = {}
    for kind, embedder in (("w2", "wasserstein"), ("l2", "basis")):
        names[kind] = _tenant()
        reg.register(_spec(names[kind], p=2.0, r=0.5, embedder=embedder))
    rng = np.random.default_rng(3)
    mu = rng.uniform(-1, 1, 200).astype(np.float32)
    sig = rng.uniform(0.2, 1.0, 200).astype(np.float32)
    w2 = reg.get(names["w2"])
    emb = w2.embedder.embed_gaussian(mu, sig)
    gids = w2.insert(emb)
    w2.delete(gids[::5])
    reg.get(names["l2"]).insert(_data(200, seed=4))   # same history
    q = w2.embedder.embed_gaussian(mu[:7] + 0.01, sig[:7])
    got = w2.index.query(q, 10, n_probes=4)
    lay = w2.index.shard_layout()
    assert lay is not None and lay["n_dev"] == 8
    assert lay == reg.get(names["l2"]).index.shard_layout()
    w2.index.unshard()
    _assert_bit_equal(got, w2.index.query(q, 10, n_probes=4))


# -- fan-out telemetry ---------------------------------------------------------


def test_fanout_telemetry_unsharded():
    name = _tenant()
    reg = ServableRegistry(device="cpu")
    sv = reg.register(_spec(name, shard_axis=None))
    emb = _data(200, seed=5)
    sv.insert(emb)                               # 3 sealed + the delta
    nq, k = 6, 10
    sv.query(emb[:nq] * 0.98, k, n_probes=4)     # through the batcher
    bal = reg.report()[name]["stats"]["shard_balance"]
    assert bal["n_sampled"] == 1
    assert len(bal["per_segment_wins"]) == len(sv.index.segments)
    assert 0 < sum(bal["per_segment_wins"]) <= 8 * k    # a padded chunk
    assert sum(bal["merge_win_rate"]) == pytest.approx(1.0, abs=0.01)
    assert bal["per_device_wins"] == []          # unsharded: no ranks


def test_fanout_telemetry_sharded():
    name = _tenant()
    reg = ServableRegistry(device="cpu", mesh=_mesh(4))
    sv = reg.register(_spec(name))
    emb = _data(260, seed=6)
    sv.insert(emb)
    nq, k = 5, 10
    sv.query(emb[:nq] * 0.98, k, n_probes=4)
    sv.query(emb[5:5 + nq] * 0.98, k, n_probes=4)
    bal = reg.report()[name]["stats"]["shard_balance"]
    assert bal["n_sampled"] == 2
    assert len(bal["per_device_wins"]) == 4
    assert sum(bal["per_device_wins"]) == sum(bal["per_segment_wins"])
    assert 0 < sum(bal["per_device_wins"]) <= 2 * 8 * k
    assert bal["device_imbalance"] >= 1.0
    m = obs_metrics.registry()
    assert sum(m.value("serve_device_wins_total", tenant=name,
                       device=str(d)) or 0 for d in range(4)) == \
        sum(bal["per_device_wins"])


def test_shard_balance_single_device_imbalance_is_exactly_one():
    """(``tests/test_serve.py``.)  On a 1-rank mesh every win is rank 0's,
    so max / mean is exactly 1.0."""
    st = ServingStats(tenant=_tenant(), metrics=obs_metrics.MetricsRegistry())
    for wins in ([3], [11], [5]):
        st.record_fanout([wins[0]], dev_wins=wins, dev_load=[1])
    bal = st.shard_balance()
    assert bal["device_imbalance"] == 1.0
    assert bal["device_load_imbalance"] == 1.0
    st2 = ServingStats(tenant=_tenant(),
                       metrics=obs_metrics.MetricsRegistry())
    si = _index(on_fanout=st2.record_fanout)
    emb = _data(150, seed=2)
    si.insert(emb)
    si.shard(_mesh(1))
    si.fanout_telemetry(si.query(emb[:6] * 0.98, 10, n_probes=4)[0].numpy())
    bal = st2.shard_balance()
    assert sum(bal["per_device_wins"]) > 0
    assert bal["device_imbalance"] == 1.0


def test_shard_balance_zero_candidate_reports():
    """(``tests/test_serve.py``.)  A merge with no winner reports cleanly:
    empty win rates, zero imbalance."""
    st = ServingStats(tenant=_tenant(), metrics=obs_metrics.MetricsRegistry())
    st.record_fanout([0, 0], dev_wins=[0], seg_candidates=[0, 0])
    bal = st.shard_balance()
    assert bal["n_sampled"] == 1
    assert bal["per_segment_wins"] == [0, 0]
    assert bal["per_segment_candidates"] == [0, 0]
    assert bal["merge_win_rate"] == []
    assert bal["device_imbalance"] == 0.0
    assert bal["device_load_imbalance"] == 0.0
    si = _index(on_fanout=st.record_fanout)
    si.insert(_data(5, seed=0))
    si.delete(list(range(5)))
    si.shard(_mesh(2))
    ids, _ = si.query(_data(3, seed=1), 5)
    assert (ids == -1).all()
    si.fanout_telemetry(ids.numpy())
    assert sum(st.shard_balance()["per_segment_wins"]) == 0


def test_shard_balance_wins_after_compact_replacement():
    """(``tests/test_serve.py``.)  Positional counters survive a
    compaction's re-placement and stay consistent."""
    st = ServingStats(tenant=_tenant(), metrics=obs_metrics.MetricsRegistry())
    si = _index(on_fanout=st.record_fanout)
    emb = _data(200, seed=3)
    gids = si.insert(emb)                        # 3 sealed + the delta
    si.shard(_mesh(2))
    q = emb[:6] * 0.98
    si.fanout_telemetry(si.query(q, 10, n_probes=4)[0].numpy())
    pre = st.shard_balance()
    assert len(pre["per_segment_wins"]) == len(si.segments)
    si.delete(gids[::4])
    si.maintenance.compact()
    si.fanout_telemetry(si.query(q, 10, n_probes=4)[0].numpy())
    post = st.shard_balance()
    assert post["n_sampled"] == 2
    assert len(post["per_segment_wins"]) >= len(pre["per_segment_wins"])
    assert sum(post["per_segment_wins"]) > sum(pre["per_segment_wins"])
    assert sum(post["per_device_wins"]) == sum(post["per_segment_wins"])
    assert sum(post["merge_win_rate"]) == pytest.approx(1.0, abs=0.01)
    st.reset_fanout()
    assert st.shard_balance()["n_sampled"] == 0


# -- durability onto a mesh ------------------------------------------------------


def test_recover_and_standby_place_onto_their_mesh(tmp_path):
    """A WAL-backed sharded primary (a ``SET_REPLICATION`` in its log):
    ``recover`` into a registry on a 3-rank mesh and a ``WalStandby`` on a
    5-rank mesh each shard the tenant over their own mesh, keep the
    logged policy, and answer bit for bit as the primary."""
    from repro_torch.serve import WalStandby
    name = _tenant()
    wal_dir, snap = str(tmp_path / "wal"), str(tmp_path / "snap")
    prim = ServableRegistry(device="cpu", mesh=_mesh(8), wal_dir=wal_dir,
                            fsync_every=1)
    sv = prim.register(_spec(name))
    gids = sv.insert(_data(300, seed=21))
    prim.snapshot(snap, step=1)
    sv.delete(gids[::4])
    sv.maintenance.set_replication([2, 1, 3])
    sv.insert(_data(90, seed=22))
    q = _data(7, seed=23, scale=0.9)
    want = sv.index.query(q, 10, n_probes=4)

    reg = ServableRegistry(device="cpu", mesh=_mesh(3))
    rep = reg.recover(ckpt_root=snap, wal_dir=wal_dir)
    assert rep[name]["restored_step"] == 1
    idx = reg.get(name).index
    assert idx.replication() == (2, 1, 3)
    assert idx.shard_layout()["n_dev"] == 3
    assert idx.shard_layout()["replication"][:3] == [2, 1, 3]
    _assert_bit_equal(idx.query(q, 10, n_probes=4), want)
    idx.attach_wal(None)

    sb = WalStandby(wal_dir, device="cpu", mesh=_mesh(5))
    sb.poll_once()
    sidx = sb.registry.get(name).index
    assert sidx.shard_layout()["n_dev"] == 5
    _assert_bit_equal(sidx.query(q, 10, n_probes=4), want)
    sb.stop()


def test_maintenance_under_a_query_thread_while_sharded():
    """Placement rebuilds on a maintenance worker (compaction, seal,
    set_replication, each refreshing the placement) while a thread queries
    the tenant on a 4-rank mesh, with a short switch interval: no bucket
    overflows, so every answer equals the one before the jobs."""
    import sys
    import threading
    from repro_torch.serve import MaintenancePool
    name = _tenant()
    reg = ServableRegistry(device="cpu", mesh=_mesh(4))
    sv = reg.register(_spec(name, replication="static:2"))
    gids = sv.insert(_data(600, seed=31))
    sv.delete(gids[::3])
    q = _data(8, seed=32, scale=0.9)
    want = _bits(sv.index.query(q, 10, n_probes=4))
    answers, errors, stop = [], [], threading.Event()

    def stream():
        try:
            while not stop.is_set():
                answers.append(_bits(sv.index.query(q, 10, n_probes=4)))
        except Exception as e:                   # noqa: BLE001
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pool = MaintenancePool(reg, workers=2)
    th = threading.Thread(target=stream)
    try:
        th.start()
        jobs = [pool.submit(name, "compact"), pool.submit(name, "seal"),
                pool.submit(name, "set_replication", replication=3)]
        sts = [pool.wait(j, timeout_s=120.0) for j in jobs]
    finally:
        stop.set()
        th.join(timeout=120.0)
        pool.stop(timeout_s=120.0)
        sys.setswitchinterval(old)
    assert not th.is_alive()
    assert not any(t.is_alive() for t in pool._threads)
    assert not errors, errors
    assert [s["status"] for s in sts] == ["done"] * 3
    assert sv.index.shard_layout()["replication"] == \
        [3] * sv.index.shard_layout()["n_sealed"]
    assert answers
    for g, d in answers + [_bits(sv.index.query(q, 10, n_probes=4))]:
        np.testing.assert_array_equal(g, want[0])
        np.testing.assert_array_equal(d, want[1])
