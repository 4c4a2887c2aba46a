"""The port's serve path against the JAX package's, on the CPU.

One numpy-drawn family goes into both packages' ``SegmentedIndex``; over
several segments with tombstones, the merged gids must equal JAX's
(invariant 3, "segmentation is invisible", held across packages), and the
recall proxy must agree.  The basis embedder is allclose to JAX's kernel-
form embedding (not bit-equal: the two stacks sum in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.embedders import make_embedder as j_make_embedder  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro.serve import recall_proxy as j_recall_proxy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.embedders import make_embedder  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import (MicroBatcher, SegmentedIndex,  # noqa: E402
                               Servable, ServableRegistry, ServableSpec,
                               occupancy_report, recall_proxy)

N_DIMS = 16


def _cfgs(p=2.0):
    kw = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=2.0, p=p)
    return jidx.IndexConfig(**kw), tidx.IndexConfig(**kw)


def _family(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_DIMS, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.uint32))


def _data(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


@pytest.mark.parametrize("n_probes", [1, 4])
def test_segmented_gids_equal_to_jax(n_probes):
    cfg_j, cfg_t = _cfgs()
    fam = _family()
    js = JSegmentedIndex(cfg_j, segment_capacity=128, insert_chunk=64,
                         family=tuple(jnp.asarray(a) for a in fam))
    ts = SegmentedIndex(cfg_t, segment_capacity=128, insert_chunk=64,
                        family=convert.family_from_numpy(*fam, device="cpu"),
                        device="cpu")
    emb = _data(300, seed=1)
    for part in (emb[:100], emb[100:260], emb[260:]):
        gj, gt = js.insert(part), ts.insert(part)
        np.testing.assert_array_equal(gt, gj)
    assert len(ts.segments) == len(js.segments) == 3
    assert js.delete(np.arange(0, 300, 7)) == ts.delete(np.arange(0, 300, 7))
    q = _data(9, seed=2, scale=0.9)
    want_g, want_d = js.query(q, 10, n_probes=n_probes)
    got_g, got_d = ts.query(q, 10, n_probes=n_probes)
    assert got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-6)
    # a single segment fan-out equals a one-index build over the live items
    assert ts.n_live == js.n_live
    assert recall_proxy(ts, q, 10, n_probes) == pytest.approx(
        j_recall_proxy(js, q, 10, n_probes), abs=1e-6)
    e_t, g_t = ts.live_items()
    e_j, g_j = js.live_items()
    np.testing.assert_array_equal(g_t.numpy(), g_j)
    np.testing.assert_array_equal(e_t.numpy(), e_j)


def test_segment_lifecycle_and_validation():
    _, cfg_t = _cfgs()
    si = SegmentedIndex(cfg_t, segment_capacity=64, insert_chunk=32,
                        device="cpu")
    g1 = si.insert(_data(40, seed=5))
    assert len(si.segments) == 1 and not si.delta.sealed
    g2 = si.insert(_data(40, seed=6))
    assert len(si.segments) == 2 and si.segments[0].sealed
    assert si.delete(np.concatenate([g1[:10], g2[-5:], g1[:2]])) == 15
    assert si.delete(g1[:10]) == 0 and si.delete([10 ** 6]) == 0
    rep = occupancy_report(si)
    assert rep["n_live"] == 65 and rep["n_items"] == 80
    bad = _data(3, seed=7)
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        si.insert(bad)
    with pytest.raises(ValueError, match="shape"):
        si.insert(np.zeros((2, N_DIMS + 1), np.float32))
    with pytest.raises(ValueError, match="already present"):
        si.insert(_data(1, seed=8), gids=[int(g1[-1])])
    assert si.n_rejected == 5 and si.n_items == 80
    empty = SegmentedIndex(cfg_t, segment_capacity=64, device="cpu")
    g, d = empty.query(_data(2, seed=9), 5)
    assert (g == -1).all() and torch.isinf(d).all()


def test_basis_embedder_allclose_to_jax_kernel_form():
    je = j_make_embedder("basis", 64)
    te = make_embedder("basis", 64, device="cpu")
    np.testing.assert_allclose(te.nodes(), je.nodes(), rtol=0, atol=1e-6)
    x = np.random.default_rng(3).normal(size=(50, 64)).astype(np.float32)
    want = jops.cheb_embed(jnp.asarray(x) * je._pre, je._mat, je._scale,
                           backend="reference")
    got = te.embed_batched(x, batch_size=32)          # ragged tail padded
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the JAX package's constants carried over give the same embedding
    te.set_constants(*convert.basis_constants_from_numpy(
        je._pre, je._mat, je._scale, device="cpu"))
    np.testing.assert_allclose(te.embed(x).numpy(), np.asarray(want),
                               atol=1e-5)


def test_legendre_embedder_matches_jax():
    je = j_make_embedder("basis", 16, params={"basis": "legendre"})
    te = make_embedder("basis", 16, params={"basis": "legendre"},
                       device="cpu")
    x = np.random.default_rng(4).normal(size=(6, 32)).astype(np.float32)
    np.testing.assert_allclose(te.embed(x).numpy(), np.asarray(je.embed(x)),
                               atol=1e-5)


def test_batcher_pads_to_the_palette_and_scatters_back():
    now = [0.0]
    seen = []

    def fn(buf, k, n_probes):
        seen.append(buf.shape[0])
        return (np.tile(np.arange(buf.shape[0])[:, None], (1, k)),
                np.zeros((buf.shape[0], k), np.float32))

    b = MicroBatcher(fn, chunk_sizes=(4, 8), max_delay_ms=5.0,
                     clock=lambda: now[0])
    f1 = b.submit(np.zeros((3, 2)), k=2)
    f2 = b.submit(np.zeros((2, 2)), k=2)
    assert b.pump() == 0 and b.pending() == 2        # before the deadline
    now[0] = 0.01
    assert b.pump() == 1 and seen == [8]
    np.testing.assert_array_equal(f1.result()[0][:, 0], [0, 1, 2])
    np.testing.assert_array_equal(f2.result()[0][:, 0], [3, 4])
    f3 = b.submit(np.zeros((11, 2)), k=2)            # splits: 8 + 4
    b.flush_all()
    assert seen[1:] == [8, 4] and f3.result()[0].shape == (11, 2)
    assert b.unique_shapes() == 2
    with pytest.raises(ValueError):
        MicroBatcher(fn, chunk_sizes=(8, 4))


def test_servable_query_paths_agree():
    spec = ServableSpec(name="t", n_dims=N_DIMS, r=2.0, n_tables=4,
                        log2_buckets=8, bucket_capacity=64,
                        segment_capacity=64, insert_chunk=32,
                        chunk_sizes=(4, 16))
    reg = ServableRegistry(device="cpu")
    sv = reg.register(spec, family=convert.family_from_numpy(
        *_family(), device="cpu"))
    assert reg.names() == ["t"] and reg.get("t") is sv
    with pytest.raises(ValueError):
        reg.register(spec)
    emb = sv.embed(np.random.default_rng(0).normal(size=(100, N_DIMS)))
    gids = sv.insert(emb)
    sv.delete(gids[:5])
    q = emb[10:17].numpy()
    fut = sv.submit_query(q, 5, 2)
    sv.batcher.flush_all()
    g_async, d_async = fut.result()
    g_sync, _ = sv.query(q, 5, 2)
    g_direct, _ = sv.index.query(q, 5, n_probes=2)
    np.testing.assert_array_equal(g_async, g_direct.numpy())
    np.testing.assert_array_equal(g_sync, g_direct.numpy())
    np.testing.assert_array_equal(g_async[:, 0], gids[10:17])
    rep = reg.report()["t"]
    assert rep["stats"]["totals"] == {"queries": 14, "inserts": 100,
                                      "deletes": 5, "batches": 2,
                                      "rejected_inserts": 0}
    assert rep["occupancy"]["n_live"] == 95


def test_serve_demo_runs_on_cpu():
    """The CLI serves the JAX demo's three tenants by default; the report
    has one entry per tenant."""
    report = tserve.main(["--device", "cpu", "--n-items", "1024",
                          "--steps", "2", "--recall-probe-size", "8"])
    assert tuple(report) == ("l1-qmc", "l2-basis", "w2-quantile")
    for rep in report.values():
        assert rep["n_segments"] == 2 and rep["requests"] == 8
        assert rep["query_rows"] == 64
        assert rep["self_hit_rate"] == 1.0
        assert 0.0 < rep["held_frac"] <= 1.0
        assert 0.0 <= rep["recall_at_k"] <= 1.0
        assert all(v == 0 for v in rep["launches"].values())  # no kernels
        # on the CPU: the plain versions ran


def test_servable_refuses_to_run_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Servable(ServableSpec(name="x"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--n-items", "8"])


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_merge_inputs_hold_no_negative_zero(monkeypatch, precision):
    """K3's select route takes no -0.0 and no NaN (the network calls -0.0
    equal to +0.0).  Every fan-in and survivor sort of the demo, at both
    tiers, sees distances that are +inf or sums of non-negative terms."""
    from repro_torch.kernels import ops as tops
    seen = []
    real = tops.merge_topk

    def spy(dists, ids, k):
        seen.append(dists.clone())
        return real(dists, ids, k)
    monkeypatch.setattr(tops, "merge_topk", spy)
    tserve.run(device="cpu", n_items=2048, steps=2, recall_probe_size=8,
               self_hit_probes=8, precision=precision, log=lambda *a: None)
    assert len(seen) >= 2
    for d in seen:
        assert not torch.isnan(d).any()
        assert not (torch.signbit(d) & (d == 0)).any()
        assert (d >= 0).all()
