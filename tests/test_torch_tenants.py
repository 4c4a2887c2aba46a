"""The JAX demo's l1-qmc and w2-quantile tenants in the port against the JAX
package, on the CPU, and the port's three-tenant launcher.

Tolerances: each tenant's pipeline (embed, insert over several segments,
delete, query) runs in both packages from the same inputs with one
injected family.  The embeddings are bit-equal (``tests/test_torch_
embedders.py``); rows whose gids differ must be explained by a query or
item projection near a floor boundary (|proj - round(proj)| <= 1e-4 +
1e-6 |proj|, relative for the Cauchy family; counted), every other row's
gids equal where the reference's distances are distinct (ties counted),
distances of equal gids rtol 1e-5 atol 1e-6, and recall@10 within 0.01.
With a huge alpha entry (hashes far from 0 and saturated ones) tables and
probed buckets are bit-equal.  The W2 gate (``launch.w2_gate``, the
bench's smoke config) must reach the bench's recall@10 >= 0.9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.embedders import make_embedder as j_make  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro.serve import recall_proxy as j_recall  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.embedders import make_embedder  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import w2_gate  # noqa: E402
from repro_torch.serve import SegmentedIndex, recall_proxy  # noqa: E402

N_ITEMS = 2048
K = 10


def _specs():
    return {sp.name: sp for sp in tserve.default_specs()}


def _family(cfg, seed=7):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_dims, cfg.n_tables * cfg.n_hashes)
    alpha = (rng.standard_cauchy(size=shape) if cfg.p == 1.0
             else rng.normal(size=shape)).astype(np.float32)
    b = rng.uniform(size=(shape[1],)).astype(np.float32)
    mix = (rng.integers(0, 2 ** 31 - 1, size=(cfg.n_tables, cfg.n_hashes))
           | 1).astype(np.uint32)
    return alpha, b, mix


def _near(proj):
    return (np.abs(proj - np.round(proj))
            <= 1e-4 + 1e-6 * np.abs(proj)).any(axis=-1)


def _proj(x, fam, r):
    return ref.hash_mm_proj_ref(*(torch.as_tensor(np.array(t)) for t in (
        x, fam[0], fam[1])), r)[1].numpy()


@pytest.mark.parametrize("name", ["l1-qmc", "w2-quantile"])
@pytest.mark.parametrize("n_probes", [1, 4])
def test_tenant_pipeline_matches_jax(name, n_probes):
    spec = _specs()[name]
    cfg_t = spec.index_config()
    cfg_j = jidx.IndexConfig(**{f: getattr(cfg_t, f) for f in (
        "n_dims", "n_tables", "n_hashes", "log2_buckets",
        "bucket_capacity", "r", "p")})
    fam = _family(cfg_t)
    kw = dict(n_dims=spec.n_dims, p=spec.p, volume=spec.volume)
    je = j_make(spec.embedder, **kw)
    te = make_embedder(spec.embedder, device="cpu", **kw)
    js = JSegmentedIndex(cfg_j, segment_capacity=512, insert_chunk=256,
                         family=tuple(jnp.asarray(a) for a in fam))
    ts = SegmentedIndex(cfg_t, segment_capacity=512, insert_chunk=256,
                        family=convert.family_from_numpy(*fam, device="cpu"),
                        device="cpu")
    rng = np.random.default_rng(11)

    class _Sv:                       # what sample_inputs reads of a tenant
        pass
    sv = _Sv()
    sv.spec, sv.nodes = spec, te.nodes
    x, _ = tserve.sample_inputs(sv, rng, N_ITEMS)
    emb_t = te.embed_batched(x, batch_size=128)
    emb_j = np.asarray(je.embed_batched(np.asarray(x, np.float32),
                                        batch_size=128))
    np.testing.assert_array_equal(emb_t.numpy(), emb_j)
    for part in (slice(0, 700), slice(700, 1500), slice(1500, N_ITEMS)):
        np.testing.assert_array_equal(ts.insert(emb_t[part]),
                                      js.insert(emb_j[part]))
    assert len(ts.segments) == len(js.segments) == 4
    victims = np.arange(0, N_ITEMS, 13)
    assert ts.delete(victims) == js.delete(victims)
    base = te.embed(tserve.sample_inputs(sv, rng, 64)[0]).numpy()
    q = base + rng.normal(scale=0.05, size=base.shape).astype(np.float32)
    g, d = (t.numpy() for t in ts.query(q, K, n_probes=n_probes))
    gj, dj = (np.asarray(a) for a in js.query(q, K + 1, n_probes=n_probes))
    # rows that differ: a query or an item near a floor boundary
    q_near = _near(_proj(q, fam, cfg_t.r))
    item_near = set(np.nonzero(_near(_proj(emb_j, fam, cfg_t.r)))[0])
    rows = np.nonzero((g != gj[:, :K]).any(axis=1))[0]
    explained = [r for r in rows if q_near[r] or (
        set(g[r]) ^ set(gj[r, :K])) & item_near]
    ties = 0
    for r in sorted(set(range(64)) - set(explained)):
        dr = dj[r]
        distinct = np.ones(K, bool)
        distinct[1:] &= dr[1:K] != dr[:K - 1]
        distinct &= dr[:K] != dr[1:K + 1]
        ties += int((~distinct & np.isfinite(dr[:K])).sum())
        np.testing.assert_array_equal(g[r][distinct], gj[r, :K][distinct])
        same = (g[r] == gj[r, :K]) & np.isfinite(dr[:K])
        np.testing.assert_allclose(d[r][same], dr[:K][same], rtol=1e-5,
                                   atol=1e-6)
    assert len(explained) <= 3, (len(rows), len(explained), ties)
    rec_t = recall_proxy(ts, q, K, n_probes)
    rec_j = j_recall(js, q, K, n_probes)
    assert abs(rec_t - rec_j) <= 0.01


@pytest.mark.parametrize("huge", [1e6, 1e9])
def test_huge_alpha_entry_mixes_as_jax(huge):
    """p = 1 family with two alpha entries of +-``huge``: hashes far from 0
    (and, at 1e9, saturated ones, whose +1 probe wraps) mix to bit-equal
    tables, counts and probed buckets.  The inputs make every projection
    exact in f32 whatever the summation order (quarter-integer alpha,
    small integer x; a row that reaches a huge entry has no other term),
    so both packages hash alike and only the mixing is under test."""
    spec = _specs()["l1-qmc"]
    cfg_t = spec.index_config()
    cfg_j = jidx.IndexConfig(**{f: getattr(cfg_t, f) for f in (
        "n_dims", "n_tables", "n_hashes", "log2_buckets",
        "bucket_capacity", "r", "p")})
    alpha, b, mix = _family(cfg_t, seed=3)
    alpha = np.clip(np.round(alpha * 4) / 4, -1000, 1000).astype(np.float32)
    alpha[5, 2], alpha[9, 17] = huge, -huge
    fam = (alpha, b, mix)
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, size=(600, 64)).astype(np.float32)
    x[:, [5, 9]] = 0.0
    x[:40] = 0.0
    x[:20, 5] = rng.integers(1, 25, size=20)       # up to 24 x 1e9 / 8
    x[20:40, 9] = rng.integers(-25, 25, size=20)
    hj, pj = jidx.hash_stage(jnp.asarray(alpha), jnp.asarray(b), cfg_j,
                             jnp.asarray(x))
    ht, pt = tidx.hash_stage(torch.as_tensor(alpha), torch.as_tensor(b),
                             cfg_t, torch.as_tensor(x))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert np.abs(np.asarray(hj)).max() > 10 ** 5
    if huge >= 1e9:
        assert (np.asarray(hj) == 2 ** 31 - 1).any()
        assert (np.asarray(hj) == -2 ** 31).any()
    sj = jidx.create_index(jax.random.PRNGKey(0), cfg_j, 1024,
                           family=tuple(jnp.asarray(a) for a in fam))
    st = tidx.create_index(cfg_t, 1024, family=convert.family_from_numpy(
        *fam, device="cpu"), device="cpu")
    bj = jidx.build_index(sj, cfg_j, jnp.asarray(x))
    bt = tidx.build_index(st, cfg_t, x)
    for leaf in ("table", "counts"):
        np.testing.assert_array_equal(getattr(bt, leaf).numpy(),
                                      np.asarray(getattr(bj, leaf)))
    for n_probes in (4, 9):
        want = jidx.probe_stage(jnp.asarray(mix), cfg_j, hj, pj, n_probes)
        got = tidx.probe_stage(bt.mix, cfg_t, ht, pt, n_probes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w2_gate_smoke_config_reaches_the_bench_bar():
    """bench_wasserstein_serve's smoke config (512 Gaussians, 16 queries,
    r in {0.25, 0.5, 1.0}, 16 tables x 4 hashes, 64-slot buckets) against
    the closed-form W2 in the port: best recall@10 >= 0.9."""
    res = w2_gate.run(n_db=512, n_q=16, device="cpu")
    assert set(res["recall_at_10"]) == {"0.25", "0.5", "1.0"}
    assert res["best_recall_at_10"] >= w2_gate.MIN_RECALL
    assert res["best_r"] in w2_gate.R_SWEEP


def test_w2_gate_cli_smoke(capsys):
    res = w2_gate.main(["--device", "cpu", "--smoke"])
    assert res["n_db"] == 512
    assert "[w2_gate] OK" in capsys.readouterr().out


def test_default_specs_are_the_jax_demo_tenants():
    from repro.launch.serve import default_specs as j_specs
    got = tserve.default_specs()
    want = j_specs()
    assert [s.name for s in got] == [s.name for s in want] == list(
        tserve.TENANTS)
    for a, b in zip(got, want):
        for f in ("p", "r", "embedder", "n_dims", "n_tables", "n_hashes",
                  "log2_buckets", "bucket_capacity", "segment_capacity",
                  "chunk_sizes", "precision"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
    assert tserve.default_spec() == got[0]


def test_launcher_serves_three_tenants_on_the_cpu():
    seen = {}

    def on_insert(name, gids, params):
        seen.setdefault(name, []).append((len(gids), params))
    dispatch.reset_launches()
    report = tserve.run(device="cpu", n_items=1024, steps=3,
                        recall_probe_size=16, self_hit_probes=16,
                        segment_capacity=256, on_insert=on_insert,
                        log=lambda *a: None)
    assert tuple(report) == ("l1-qmc", "l2-basis", "w2-quantile")
    for name, rep in report.items():
        spec = _specs()[name]
        assert (rep["embedder"], rep["p"], rep["r"]) == (
            spec.embedder, spec.p, spec.r)
        assert rep["n_items_filled"] == 1024
        assert rep["n_live"] == 1024 + 3 * 64 - 3 * 3
        assert rep["n_segments"] == 5 and rep["requests"] == 12
        assert rep["self_hit_rate"] == 1.0
        assert 0.0 < rep["held_frac"] <= 1.0
        assert 0.0 <= rep["recall_at_k"] <= 1.0
    assert report["w2-quantile"]["recall_at_k"] >= 0.9
    assert not any(dispatch.launches.values())
    for name, calls in seen.items():
        assert sum(n for n, _ in calls) == 1024 + 3 * 64
        for n, params in calls:
            if name == "w2-quantile":
                mu, sig = params
                assert mu.shape == sig.shape == (n,)
                assert (sig >= 0.1).all() and (np.abs(mu) <= 1.0).all()
            else:
                assert params is None


def test_launcher_tenant_streams_do_not_depend_on_the_others():
    """Each tenant draws from its own generator: served alone it holds the
    items it holds beside the others."""
    kw = dict(device="cpu", n_items=300, steps=2, recall_probe_size=8,
              self_hit_probes=8, log=lambda *a: None)
    both = tserve.run(tenants=("l1-qmc", "w2-quantile"), registry=None, **kw)
    reg = tserve.ServableRegistry(device="cpu")
    alone = tserve.run(tenants=("l1-qmc",), registry=reg, **kw)
    assert tuple(alone) == ("l1-qmc",)
    assert alone["l1-qmc"]["recall_at_k"] == both["l1-qmc"]["recall_at_k"]
    reg2 = tserve.ServableRegistry(device="cpu")
    tserve.run(tenants=("l1-qmc", "w2-quantile"), registry=reg2, **kw)
    e1, g1 = reg.get("l1-qmc").index.live_items()
    e2, g2 = reg2.get("l1-qmc").index.live_items()
    assert torch.equal(g1, g2) and torch.equal(e1, e2)


def test_launcher_rejects_unknown_tenants():
    with pytest.raises(ValueError, match="unknown tenants"):
        tserve.run(device="cpu", tenants=("l3-fourier",), log=lambda *a: None)


def test_cli_tenants_flag():
    report = tserve.main(["--device", "cpu", "--tenants", "w2-quantile",
                          "--n-items", "256", "--steps", "1",
                          "--recall-probe-size", "8"])
    assert tuple(report) == ("w2-quantile",)
    assert report["w2-quantile"]["query_rows"] == 32
