"""The port's replicated serving on the CPU: the placement plan, the
router, the replicated fan-in, the registry's policies, and parity.

Mirrors ``tests/test_replicated_serve.py`` case by case.  Replication
changes where a query runs, never its answer (the JAX package's invariant
6): whether the router activates one replica of each segment or every
replica answers and the fan-in drops the copies by gid, the merged top k
equals the unreplicated sharded answer, which equals the stacked one.

* ``normalize_replication``, ``replicated_assignment``, ``layout_dict``,
  ``auto_factors`` and a ``QueryRouter``'s plan sequence equal the JAX
  functions' outputs for n_dev in {1, 2, 3, 8} (pure host functions);
* ``ops.merge_topk_unique`` equals the JAX op, drops replica copies, and
  is bit for bit ``merge_topk`` on rows without one;
* on 4- and 8-rank CPU meshes, routed and all-active replicated answers
  are bit-equal to the unsharded query, batch after batch, at fp32 and
  int8; ``auto`` factors from real telemetry re-place at a compaction;
* one subprocess runs the JAX package on 8 forced host devices, for the
  one value no pure function gives: its ``shard_balance`` after a routed
  stream, which the port's equals on the same family and stream.

Private metrics registries or tenant names unique to the test; the
subprocess has a timeout and inherits no ``REPRO_*`` variable.
"""

import json
import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro.serve.router import QueryRouter as JRouter  # noqa: E402
from repro.serve.router import auto_factors as jauto  # noqa: E402
from repro.sharding import placement as jplacement  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import (QueryRouter, SegmentedIndex,  # noqa: E402
                               ServableRegistry, ServableSpec, ServingStats,
                               auto_factors)
from repro_torch.core import distributed  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DIMS = 16
N_DEVS = [1, 2, 3, 8]
CFG_KW = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=2.0)


def _data(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _family(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_DIMS, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.uint32))


def _tenant():
    return "repl-" + uuid.uuid4().hex[:10]


def _index(precision="fp32", **kw):
    return SegmentedIndex(tidx.IndexConfig(**CFG_KW), segment_capacity=64,
                          insert_chunk=32, device="cpu", precision=precision,
                          tenant=_tenant(),
                          family=convert.family_from_numpy(*_family(),
                                                           device="cpu"),
                          **kw)


def _mesh(n):
    return make_serve_mesh(n, device="cpu")


def _assert_bit_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  want[1].numpy().view(np.uint32))


# -- the placement plan (host functions) --------------------------------------


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_normalize_replication(n_dev):
    assert placement.normalize_replication(3, 4, None) == (1, 1, 1)
    assert placement.normalize_replication(3, 4, 2) == (2, 2, 2)
    assert placement.normalize_replication(3, 2, [9, 0]) == (2, 1, 1)
    assert placement.normalize_replication(1, 4, [2, 3, 4]) == (2,)
    assert placement.normalize_replication(0, 4, 3) == ()
    for n_sealed in (0, 1, 5, 9):
        for rep in (None, 1, 2, 8, [9, 0], [2, 3, 4], (8, 1, 1, 4)):
            assert placement.normalize_replication(n_sealed, n_dev, rep) \
                == jplacement.normalize_replication(n_sealed, n_dev, rep)


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_replicated_assignment_factor1_is_round_robin(n_dev):
    for n in (0, 1, 4, 7, 13):
        assert placement.replicated_assignment(n, n_dev, (1,) * n) == \
            placement.round_robin(n, n_dev) == \
            jplacement.replicated_assignment(n, n_dev, (1,) * n)


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_replicated_assignment_spreads_replicas(n_dev):
    asn = placement.replicated_assignment(4, 4, (3, 1, 1, 1))
    assert len([d for d, b in enumerate(asn) if 0 in b]) == 3
    assert max(len(b) for b in asn) - min(len(b) for b in asn) <= 1
    rng = np.random.default_rng(n_dev)
    for n in (1, 5, 11):
        for _ in range(4):
            fac = placement.normalize_replication(
                n, n_dev, rng.integers(1, n_dev + 2, size=n).tolist())
            got = placement.replicated_assignment(n, n_dev, fac)
            assert got == jplacement.replicated_assignment(n, n_dev, fac)
            assert all(len(b) == len(set(b)) for b in got)
            assert sum(len(b) for b in got) == sum(fac)


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_layout_dict_reports_replication(n_dev):
    mesh = _mesh(n_dev)
    lay = placement.layout_dict(mesh, "serve", 3, replication=[5, 1, 1])
    assert lay == jplacement.layout_dict(mesh, "serve", 3,
                                         replication=[5, 1, 1])
    assert lay["replication"] == [min(5, n_dev), 1, 1]
    assert lay["n_instances"] == min(5, n_dev) + 2
    if n_dev == 1:      # factors clip: the unreplicated layout
        assert lay == placement.layout_dict(mesh, "serve", 3)


# -- the router ----------------------------------------------------------------


def _layout(n_dev, assignment, n_sealed):
    per_dev = max(1, max(len(a) for a in assignment))
    return {"n_dev": n_dev, "per_dev": per_dev, "n_sealed": n_sealed,
            "assignment": assignment}


def _router(layout):
    return QueryRouter(layout, tenant=_tenant(), metrics=MetricsRegistry())


def test_router_activates_one_replica_per_segment():
    r = _router(_layout(3, [[0], [1, 0], [2]], 3))
    for _ in range(6):
        plan = r.route()
        assert set(plan.dev_of) == {0, 1, 2}
        assert plan.dev_of[1] == 1 and plan.dev_of[2] == 2
        assert int(plan.active.sum()) == 3
        d0 = plan.dev_of[0]
        assert plan.active[d0 * r.per_dev:(d0 + 1) * r.per_dev].any()


def test_router_prefers_least_loaded_device():
    r = _router(_layout(4, [[1, 0], [2, 0], [3, 0], [0]], 4))
    for _ in range(8):
        assert r.route().dev_of[0] == 3
    load = r.device_load()
    assert load[0] == 16
    assert load[1] == load[2] == load[3] == 8
    reg = r.metrics
    assert reg.value("router_device_load", tenant=r.tenant,
                     device="0") == 16.0


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_router_deterministic(n_dev):
    """The port's plan sequence equals the JAX router's, on assignments
    with replicated segments."""
    rng = np.random.default_rng(40 + n_dev)
    for n_sealed in (1, 6, 13):
        fac = placement.normalize_replication(
            n_sealed, n_dev, rng.integers(1, 4, size=n_sealed).tolist())
        lay = placement.layout_dict(_mesh(n_dev), "serve", n_sealed,
                                    replication=fac)
        a, b = _router(lay), _router(lay)
        j = JRouter(lay, tenant=_tenant())
        for _ in range(5):
            pa, pb, pj = a.route(), b.route(), j.route()
            for p in (pb, pj):
                np.testing.assert_array_equal(pa.active, p.active)
                assert pa.dev_of == p.dev_of
                assert pa.per_device_active == p.per_device_active
        assert a.device_load() == j.device_load()


@pytest.mark.parametrize("n_dev", N_DEVS)
def test_auto_factors(n_dev):
    assert auto_factors([10, 11, 9, 10], 8) == [1, 1, 1, 1]
    assert auto_factors([80, 7, 7, 6], 8) == [3, 1, 1, 1]
    assert auto_factors([100, 0], 4) == [2, 1]
    assert auto_factors([400, 1, 1, 1], 8, max_factor=2) == [2, 1, 1, 1]
    assert auto_factors([], 4) == []
    assert auto_factors([0, 0], 4) == [1, 1]
    rng = np.random.default_rng(n_dev)
    for _ in range(6):
        wins = rng.integers(0, 200, size=rng.integers(1, 12)).tolist()
        for mf in (None, 2):
            assert auto_factors(wins, n_dev, max_factor=mf) == \
                jauto(wins, n_dev, max_factor=mf)


# -- the replicated fan-in -----------------------------------------------------


def test_merge_topk_unique_drops_replica_duplicates():
    d = torch.tensor([[0.5, 0.1, 0.5, 0.3, torch.inf]])
    g = torch.tensor([[7, 3, 7, 5, -1]], dtype=torch.int32)
    dd, gg = ops.merge_topk_unique(d, g, 4)
    assert gg.tolist() == [[3, 5, 7, -1]]
    np.testing.assert_array_equal(dd.numpy()[0, :3],
                                  np.asarray([0.1, 0.3, 0.5], np.float32))
    assert torch.isinf(dd[0, 3])


@pytest.mark.parametrize("rows,k", [(6, 10), (32, 10), (5, 40)])
def test_merge_topk_unique_matches_merge_topk_without_duplicates(rows, k):
    rng = np.random.default_rng(rows)
    m = 8 * k
    d = rng.uniform(size=(rows, m)).astype(np.float32)
    g = rng.permutation(m * rows).reshape(rows, m).astype(np.int32)
    g[0, -3:] = -1                               # empty slots
    d[1, :4] = d[1, 4]                           # distance ties
    want = ops.merge_topk(torch.tensor(d), torch.tensor(g), k)
    got = ops.merge_topk_unique(torch.tensor(d), torch.tensor(g), k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    jd, jg = jops.merge_topk_unique(jnp.asarray(d), jnp.asarray(g), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))


def test_merge_topk_unique_equals_jax_on_replica_rows():
    """Rows where ranks repeat winners (bit-equal pairs), as a replicated
    fan-in sees them: the port's plain version equals the JAX op, bit for
    bit."""
    rng = np.random.default_rng(3)
    k, n_dev, rows = 10, 8, 32
    d = np.sort(rng.uniform(size=(rows, n_dev, k)).astype(np.float32), -1)
    # gids unique within a row (an item lives in one segment), but where a
    # replica repeats its segment's pairs
    g = np.stack([rng.permutation(500)[:n_dev * k] for _ in range(rows)]
                 ).reshape(rows, n_dev, k).astype(np.int32)
    for r in range(rows):                        # rank 3 repeats rank 1
        d[r, 3], g[r, 3] = d[r, 1], g[r, 1]
    d[:, 7, 6:], g[:, 7, 6:] = np.inf, -1
    d, g = d.reshape(rows, -1), g.reshape(rows, -1)
    got = ref.merge_topk_unique_ref(torch.tensor(d), torch.tensor(g), k)
    jd, jg = jops.merge_topk_unique(jnp.asarray(d), jnp.asarray(g), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jg))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(jd).view(np.uint32))
    for row in got[1].numpy():
        real = row[row >= 0]
        assert real.size == np.unique(real).size


# -- the index, one rank and many ----------------------------------------------


def test_one_device_replication_degenerates_to_parity():
    si = _index()
    gids = si.insert(_data(300, seed=1))
    si.delete(gids[::7])
    q = _data(9, seed=2, scale=0.9)
    want = si.query(q, 10, n_probes=4)
    si.shard(_mesh(1))
    with pytest.warns(DeprecationWarning):
        si.set_replication(4)
    _assert_bit_equal(si.query(q, 10, n_probes=4), want)
    assert si._router is None                    # every factor clipped to 1
    assert si.shard_layout()["replication"] == [1] * 4


def test_spec_replication_policy():
    def mk(rep):
        return ServableSpec(name="t", n_dims=N_DIMS, replication=rep)
    for rep in ("none", "static:3", "auto"):
        assert mk(rep).replication_policy() == \
            JSpec(name="t", n_dims=N_DIMS, replication=rep) \
            .replication_policy()
    assert mk("static:3").replication_policy() == 3
    for bad in ("static:0", "static:x", "always", "2"):
        with pytest.raises(ValueError, match="replication"):
            mk(bad)
        with pytest.raises(ValueError, match="replication"):
            JSpec(name="t", n_dims=N_DIMS, replication=bad)


def _spec(name, **kw):
    base = dict(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8,
                bucket_capacity=64, segment_capacity=64, insert_chunk=32,
                chunk_sizes=(8, 32), shard_axis="serve")
    base.update(kw)
    return ServableSpec(**base)


def test_registry_replication_static_and_snapshot(tmp_path):
    """``static:k`` applies at registration, rides the snapshot and
    restores (onto a mesh of another size) with the same answers."""
    name = _tenant()
    reg = ServableRegistry(device="cpu", mesh=_mesh(4))
    sv = reg.register(_spec(name, replication="static:2"))
    assert sv.index.replication() == 2
    gids = sv.insert(_data(400, seed=14))
    sv.delete(gids[::3])
    q = _data(5, seed=15, scale=0.9)
    want = sv.index.query(q, 10, n_probes=4)
    lay = sv.index.shard_layout()
    assert lay["n_instances"] == 2 * lay["n_sealed"] == 12
    reg.snapshot(str(tmp_path), step=1)
    for n in (4, 8):
        reg2 = ServableRegistry(device="cpu", mesh=_mesh(n))
        assert reg2.restore(str(tmp_path)) == [name]
        sv2 = reg2.get(name)
        assert sv2.spec.replication == "static:2"
        assert sv2.index.replication() == 2
        assert sv2.index.shard_layout()["n_dev"] == n
        _assert_bit_equal(sv2.index.query(q, 10, n_probes=4), want)


def test_servable_auto_compact_replaces():
    """Under ``auto`` a compaction derives factors from shard_balance
    (a hot segment gets replicas on a 4-rank mesh), resets the counters,
    and answers as before."""
    name = _tenant()
    reg = ServableRegistry(device="cpu", mesh=_mesh(4))
    sv = reg.register(_spec(name, replication="auto"))
    emb = _data(400, seed=5)
    gids = sv.insert(emb)
    q = emb[:8] * 0.98                           # items of segment 0
    for _ in range(4):
        sv.query(q, 1, n_probes=4)               # segment 0 wins them all
    sv.delete(gids[200:260])
    want = sv.index.query(q, 10, n_probes=4)
    with pytest.warns(DeprecationWarning):
        sv.compact()
    fac = sv.index.replication()
    assert isinstance(fac, tuple) and max(fac) > 1
    assert sv.stats.shard_balance()["n_sampled"] == 0
    assert sv.index._router is not None          # refreshed by compact
    for _ in range(3):
        _assert_bit_equal(sv.index.query(q, 10, n_probes=4), want)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_multi_device_replicated_parity_and_balance(precision):
    """Routed replicas bit-equal batch after batch, a hot segment's wins
    spread over its replicas, the all-active path deduped at the fan-in,
    and auto factors re-placed at a compaction, on a 4-rank mesh."""
    stats = ServingStats(tenant=_tenant(), metrics=MetricsRegistry())
    si = _index(precision, on_fanout=stats.record_fanout)
    emb = _data(450, seed=1)
    gids = si.insert(emb)                        # 7 sealed + the delta
    si.delete(gids[::7])
    q = emb[:9] * 0.98                           # hot: sealed segment 0
    want = si.query(q, 10, n_probes=4)
    si.shard(_mesh(4))
    _assert_bit_equal(si.query(q, 10, n_probes=4), want)

    si.maintenance.set_replication([4, 1, 1, 1, 1, 1, 1])
    lay = si.shard_layout()
    assert lay["replication"] == [4, 1, 1, 1, 1, 1, 1]
    assert lay["n_instances"] == 10
    for _ in range(8):
        got = si.query(q, 10, n_probes=4)
        _assert_bit_equal(got, want)
        si.fanout_telemetry(got[0].numpy())
    bal = stats.shard_balance()
    assert len(bal["per_device_wins"]) == 4
    assert sum(bal["per_device_load"]) > 0
    assert len([w for w in bal["per_device_wins"] if w > 0]) > 1, bal

    pl = si._current_placement()                 # every replica answers
    st = si.delta.state
    kq = si._survivor_width(10, 4)
    g_all, d_all = distributed.query_segments_sharded(
        pl, (st.alpha, st.b, st.mix), si.cfg, torch.tensor(q), kq,
        n_probes=4)
    g_one, d_one = distributed.query_segments_sharded(
        pl, (st.alpha, st.b, st.mix), si.cfg, torch.tensor(q), kq,
        n_probes=4, active=si._router.route().active)
    _assert_bit_equal((g_all, d_all), (g_one, d_one))
    if precision == "fp32":
        _assert_bit_equal((g_all, d_all), want)

    fac = auto_factors(stats.shard_balance()["per_segment_wins"][:-1], 4)
    assert len(fac) == 7 and all(1 <= f <= 4 for f in fac)
    si.maintenance.set_replication(fac)
    si.maintenance.compact()
    after = si.query(q, 10, n_probes=4)
    si.unshard()
    _assert_bit_equal(after, si.query(q, 10, n_probes=4))


# -- one JAX value that needs devices: shard_balance after a routed stream -----


_JAX_STREAM = """
    import json
    import numpy as np
    import jax.numpy as jnp
    from repro import compat
    from repro.core import index as lidx
    from repro.serve.segments import SegmentedIndex
    from repro.serve.stats import ServingStats

    cfg = lidx.IndexConfig(n_dims=16, n_tables=4, n_hashes=4,
                           log2_buckets=8, bucket_capacity=64, r=2.0)
    rng = np.random.default_rng(5)
    fam = (rng.normal(size=(16, 16)).astype(np.float32),
           rng.uniform(size=(16,)).astype(np.float32),
           (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.uint32))
    stats = ServingStats()
    si = SegmentedIndex(cfg, segment_capacity=64, insert_chunk=32,
                        family=tuple(jnp.asarray(a) for a in fam),
                        on_fanout=stats.record_fanout)
    emb = np.random.default_rng(1).normal(size=(450, 16)).astype(np.float32)
    gids = si.insert(emb)
    si.delete(gids[::7])
    si.shard(compat.make_mesh((8,), ("serve",)))
    si.maintenance.set_replication([4, 1, 3, 1, 1, 2, 1])
    out = []
    for i in range(6):
        q = (emb[9 * i:9 * i + 9] * 0.98).astype(np.float32)
        g, d = si.query(q, 10, n_probes=4)
        out.append(np.asarray(g).tolist())
    print(json.dumps({"layout": si.shard_layout(),
                      "balance": stats.shard_balance(), "gids": out}))
"""


def test_routed_shard_balance_equals_the_jax_packages():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_JAX_STREAM)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])

    stats = ServingStats(tenant=_tenant(), metrics=MetricsRegistry())
    si = _index(on_fanout=stats.record_fanout)
    emb = _data(450, seed=1)
    gids = si.insert(emb)
    si.delete(gids[::7])
    si.shard(_mesh(8))
    si.maintenance.set_replication([4, 1, 3, 1, 1, 2, 1])
    got = []
    for i in range(6):
        g, _ = si.query(emb[9 * i:9 * i + 9] * 0.98, 10, n_probes=4)
        si.fanout_telemetry(g.numpy())
        got.append(g.numpy().tolist())
    assert si.shard_layout() == want["layout"]
    assert got == want["gids"]
    assert stats.shard_balance() == want["balance"]
