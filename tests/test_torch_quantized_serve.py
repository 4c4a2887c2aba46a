"""The port's quantized storage tier against the JAX package's, on the CPU.

Mirrors ``tests/test_quantized_serve.py`` and the seal-time half of
``tests/test_quantize.py``: with one numpy-drawn family injected into both
packages, an int8 or bf16 ``SegmentedIndex`` of the port returns the JAX
index's gids (distances allclose at rtol 1e-5: the exact rescore sums in
another order); fp32 tenants build no codes; int8 keeps recall@10 >= 0.98
against fp32 and shrinks the sealed store >= 3x; the pools keep
``live_items`` exact; a failed seal leaves the delta mutable.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import (SegmentedIndex, ServableRegistry,  # noqa: E402
                               ServableSpec)

CFG_KW = dict(n_dims=16, n_tables=8, n_hashes=2, log2_buckets=8,
              bucket_capacity=32)
CFG_J, CFG_T = jidx.IndexConfig(**CFG_KW), tidx.IndexConfig(**CFG_KW)


def _family(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(16, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(8, 2)) | 1).astype(np.uint32))


def _port(precision, fam, **kw):
    return SegmentedIndex(CFG_T, segment_capacity=64, device="cpu",
                          family=convert.family_from_numpy(*fam,
                                                           device="cpu"),
                          precision=precision, **kw)


def _jax(precision, fam):
    return JSegmentedIndex(CFG_J, segment_capacity=64, precision=precision,
                           family=tuple(jnp.asarray(a) for a in fam))


def _data(n=400, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 16)).astype(np.float32),
            rng.normal(size=(5, 16)).astype(np.float32))


def _recall(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0]))
                          / max(1, (b >= 0).sum())
                          for a, b in zip(got, want)]))


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("n_probes", [1, 4])
def test_quantized_index_equals_jax(precision, n_probes):
    fam = _family()
    db, q = _data()
    js, ts = _jax(precision, fam), _port(precision, fam)
    np.testing.assert_array_equal(ts.insert(db), js.insert(db))
    assert js.delete(np.arange(0, 400, 9)) == ts.delete(np.arange(0, 400, 9))
    gj, dj = js.query(q, 10, n_probes=n_probes)
    gt, dt = ts.query(q, 10, n_probes=n_probes)
    assert gt.dtype == torch.int32 and dt.dtype == torch.float32
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    sealed = [s for s in ts.segments if s.sealed]
    assert len(sealed) == 6
    for s_t, s_j in zip(sealed, js.segments):
        assert s_t.state.db.dtype == (torch.int8 if precision == "int8"
                                      else torch.bfloat16)
        assert s_t.scale.item() == float(s_j.scale)
        np.testing.assert_array_equal(s_t.pool, np.asarray(s_j.pool))
    assert 0.0 < ts.rerank_survivor_frac <= 1.0


def test_jax_sealed_segment_carried_across_answers_alike():
    fam = _family()
    db, q = _data(200)
    js, ts = _jax("int8", fam), _port("int8", fam)
    js.insert(db)
    ts.insert(db)
    sj = js.segments[0]
    seg = convert.quantized_segment_from_numpy(
        np.asarray(sj.state.db), np.asarray(sj.scale), sj.pool,
        family=fam, table=np.asarray(sj.state.table),
        counts=np.asarray(sj.state.counts), gids=np.asarray(sj.gids),
        live=np.asarray(sj.live), n_items=sj.n_items, device="cpu")
    own = ts.segments[0]
    assert seg.sealed and seg.n_live == own.n_live == 64
    assert torch.equal(seg.state.db, own.state.db)
    assert torch.equal(seg.state.table, own.state.table)
    assert seg.scale.item() == own.scale.item()
    np.testing.assert_array_equal(seg.pool, own.pool)
    gj, dj = jidx.query_index_gids_quantized(
        sj.state, CFG_J, jnp.asarray(q), 20, sj.gids, sj.scale, n_probes=2,
        backend="reference", live_mask=sj.live)
    gt, dt = tidx.query_index_gids_quantized(
        seg.state, CFG_T, q, 20, seg.gids, seg.scale, n_probes=2,
        live_mask=seg.live)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_bf16_segment_carried_across_keeps_its_bits():
    fam = _family()
    js = _jax("bf16", fam)
    js.insert(_data(65)[0])                 # the 65th row seals the first
    sj = js.segments[0]
    assert sj.sealed
    st = convert.state_from_numpy(*fam, np.asarray(sj.state.table),
                                  np.asarray(sj.state.counts),
                                  np.asarray(sj.state.db), device="cpu")
    assert st.db.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        st.db.view(torch.int16).numpy().view(np.uint16),
        np.asarray(sj.state.db).view(np.uint16))


def test_fp32_tier_builds_no_codes_and_is_unchanged():
    fam = _family()
    db, q = _data()
    base = SegmentedIndex(CFG_T, segment_capacity=64, device="cpu",
                          family=convert.family_from_numpy(*fam,
                                                           device="cpu"))
    tier = _port("fp32", fam)
    base.insert(db)
    tier.insert(db)
    gb, db_ = base.query(q, 10, n_probes=4)
    gt, dt = tier.query(q, 10, n_probes=4)
    assert torch.equal(gb, gt) and torch.equal(db_, dt)
    assert all(s.scale is None and s.pool is None for s in tier.segments)
    assert all(s.state.db.dtype == torch.float32 for s in tier.segments)
    assert tier.rerank_survivor_frac is None


def test_int8_recall_and_store_bytes():
    fam = _family()
    db, q = _data()
    base, tier = _port("fp32", fam), _port("int8", fam)
    base.insert(db)
    tier.insert(db)
    gb, _ = base.query(q, 10, n_probes=4)
    gt, _ = tier.query(q, 10, n_probes=4)
    assert _recall(gt.numpy(), gb.numpy()) >= 0.98
    sealed_t = [s for s in tier.segments if s.sealed]
    assert sealed_t and all(s.state.db.dtype == torch.int8 for s in sealed_t)
    bt = sum(s.state.db.nbytes for s in sealed_t)
    bb = sum(s.state.db.nbytes for s in base.segments if s.sealed)
    assert bt * 3 <= bb
    assert tier.store_bytes_per_item() * 3 <= base.store_bytes_per_item()
    assert base.store_bytes_per_item() == 4 * 16


def test_live_items_exact_after_deletes():
    fam = _family()
    db, q = _data()
    base, tier, js = _port("fp32", fam), _port("int8", fam), _jax("int8", fam)
    for idx in (base, tier, js):
        idx.insert(db)
        idx.delete(np.arange(0, 400, 7))
    e_b, g_b = base.live_items()
    e_t, g_t = tier.live_items()
    e_j, g_j = js.live_items()
    assert e_t.dtype == torch.float32
    assert torch.equal(g_t, g_b) and torch.equal(e_t, e_b)
    np.testing.assert_array_equal(g_t.numpy(), g_j)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    g, _ = tier.query(q, 10, n_probes=4)
    assert not np.isin(g.numpy(), np.arange(0, 400, 7)).any()


def test_survivor_k_widens_the_pool():
    fam = _family()
    db, q = _data(300)
    narrow = _port("int8", fam, survivor_k=10)
    wide = _port("int8", fam, survivor_k=100)
    narrow.insert(db)
    wide.insert(db)
    gn, _ = narrow.query(q, 10, n_probes=4)
    gw, _ = wide.query(q, 10, n_probes=4)
    assert (gn >= 0).all() and (gw >= 0).all()


CFG_SMALL = tidx.IndexConfig(n_dims=8, n_tables=4, n_hashes=2,
                             log2_buckets=6, bucket_capacity=16)


def test_nan_rejected_at_seal_leaves_delta_mutable():
    idx = SegmentedIndex(CFG_SMALL, segment_capacity=16, precision="int8",
                         device="cpu")
    idx.insert(np.ones((4, 8), np.float32))
    # the seal-time defense: insert() already refuses NaN at the door
    idx.delta.state.db[0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        idx.maintenance.seal()
    assert not idx.delta.sealed and len(idx.segments) == 1
    assert idx.delta.scale is None and idx.delta.pool is None
    assert idx.delta.state.db.dtype == torch.float32


def test_empty_seal_is_noop_and_single_item_seals():
    idx = SegmentedIndex(CFG_SMALL, segment_capacity=16, precision="int8",
                         device="cpu")
    idx.maintenance.seal()
    assert len(idx.segments) == 1
    g, d = idx.query(np.zeros((2, 8), np.float32), 3)
    assert (g == -1).all() and torch.isinf(d).all()
    idx.insert(np.full((1, 8), 0.5, np.float32))
    idx.maintenance.seal()
    sealed = idx.segments[0]
    assert sealed.sealed and sealed.scale is not None
    assert sealed.state.db.dtype == torch.int8
    assert sealed.pool is not None and sealed.pool.dtype == np.float32
    g, d = idx.query(np.full((1, 8), 0.5, np.float32), 1, n_probes=2)
    assert int(g[0, 0]) == 0 and float(d[0, 0]) == 0.0


def test_unknown_precision_rejected():
    with pytest.raises(ValueError, match="precision"):
        SegmentedIndex(CFG_SMALL, segment_capacity=16, precision="fp8",
                       device="cpu")
    with pytest.raises(ValueError, match="precision"):
        ServableSpec(name="x", precision="fp8")


def test_servable_carries_the_tier_into_its_report():
    reg = ServableRegistry(device="cpu")
    sv = reg.register(ServableSpec(name="q8", n_dims=16, segment_capacity=64,
                                   precision="int8", survivor_k=24))
    assert sv.index.precision == "int8" and sv.index.survivor_k == 24
    sv.insert(_data(150)[0])
    sv.query(_data()[1], 5, n_probes=2)
    store = sv.report()["store"]
    assert store["precision"] == "int8"
    assert store["store_bytes_per_item"] == pytest.approx(64 * 16 / 64)
    assert 0.0 < store["rerank_survivor_frac"] <= 1.0


def test_launcher_runs_the_int8_tier_on_the_cpu():
    rep = tserve.run(device="cpu", tenants=("l2-basis",), n_items=1024,
                     steps=2, recall_probe_size=8, self_hit_probes=16,
                     segment_capacity=256, precision="int8",
                     log=lambda *a: None)["l2-basis"]
    assert rep["precision"] == "int8"
    assert rep["self_hit_rate"] >= 0.95
    assert rep["store_bytes_per_item"] <= 256 / 3
    assert 0.0 < rep["rerank_survivor_frac"] <= 1.0
    assert rep["query_rows"] == 2 * 4 * 8
