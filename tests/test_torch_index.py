"""The port's LSH index against the JAX package's, on the CPU.

One numpy-drawn hash family goes into both packages.  Bucket mixing is
bit-equal; with equal hashes, tables and counts are equal; dedup agrees on
both of its branches; queries return equal ids away from hash boundaries
and distance ties, and recall@k within 0.01.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402

N_DIMS = 16

# jitted once per config: eager JAX would compile every small op anew
_jbuild = jax.jit(jidx.build_index, static_argnums=1)
_jinsert = jax.jit(jidx.insert_items, static_argnums=1)
_jquery = jax.jit(jidx.query_index, static_argnames=(
    "cfg", "k", "n_probes", "valid_items", "backend"))
_jquery_gids = jax.jit(jidx.query_index_gids, static_argnames=(
    "cfg", "k", "n_probes", "backend"))


def _cfg(p=2.0, cap=16, log2b=8):
    kw = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=log2b,
              bucket_capacity=cap, r=2.0, p=p)
    return jidx.IndexConfig(**kw), tidx.IndexConfig(**kw)


def _family(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lk = cfg.n_tables * cfg.n_hashes
    alpha = rng.normal(size=(cfg.n_dims, lk)).astype(np.float32)
    if cfg.p == 1.0:
        alpha = rng.standard_cauchy(size=(cfg.n_dims, lk)).astype(np.float32)
    b = rng.uniform(size=(lk,)).astype(np.float32)
    mix = (rng.integers(0, 2 ** 31 - 1, size=(cfg.n_tables, cfg.n_hashes))
           | 1).astype(np.uint32)
    return alpha, b, mix


def _jfam(fam):
    return tuple(jnp.asarray(a) for a in fam)


def _data(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, N_DIMS)).astype(
        np.float32)


def _both(cfg_j, cfg_t, fam, n_cap):
    sj = jidx.create_index(jax.random.PRNGKey(0), cfg_j, n_cap,
                           family=_jfam(fam))
    st = tidx.create_index(cfg_t, n_cap,
                           family=convert.family_from_numpy(*fam,
                                                            device="cpu"),
                           device="cpu")
    return sj, st


def _assert_equal_hashes(fam, x, cfg_j, cfg_t):
    """The premise of an equal-tables check: both packages hash ``x`` to
    the same values (a projection within an ulp of an integer could floor
    either way; the seeds here have none)."""
    hj, _ = jidx.hash_stage(jnp.asarray(fam[0]), jnp.asarray(fam[1]), cfg_j,
                            jnp.asarray(x))
    ht, _ = tidx.hash_stage(torch.as_tensor(fam[0]), torch.as_tensor(fam[1]),
                            cfg_t, torch.as_tensor(x))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


@pytest.mark.parametrize("log2b", [4, 10, 12])
def test_bucket_ids_bit_equal(log2b):
    rng = np.random.default_rng(log2b)
    hashes = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(50, 8, 4),
                          dtype=np.int64).astype(np.int32)
    hashes[:10] = rng.integers(-3, 4, size=(10, 8, 4))
    mix = (rng.integers(0, 2 ** 31 - 1, size=(8, 4)) | 1).astype(np.uint32)
    want = jidx._bucket_ids(jnp.asarray(hashes), jnp.asarray(mix), log2b)
    _, _, mix_t = convert.family_from_numpy(np.zeros((1, 32), np.float32),
                                            np.zeros(32, np.float32), mix,
                                            device="cpu")
    got = tidx._bucket_ids(torch.as_tensor(hashes), mix_t, log2b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() < 2 ** log2b


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_build_and_insert_tables_equal(p):
    cfg_j, cfg_t = _cfg(p=p, cap=4, log2b=6)        # small: forces overflow
    fam = _family(cfg_j, seed=int(p))
    x = _data(300)
    _assert_equal_hashes(fam, x, cfg_j, cfg_t)
    sj, st = _both(cfg_j, cfg_t, fam, 512)
    bj = _jbuild(sj, cfg_j, jnp.asarray(x))
    bt = tidx.build_index(st, cfg_t, x)
    for leaf in ("table", "counts", "db"):
        np.testing.assert_array_equal(getattr(bt, leaf).numpy(),
                                      np.asarray(getattr(bj, leaf)))
    assert (np.asarray(bj.counts) > cfg_j.bucket_capacity).any()
    # two padded incremental chunks fill the buckets the one-shot build did
    chunk = np.zeros((256, N_DIMS), np.float32)
    for start, take in ((0, 200), (200, 100)):
        chunk[:] = 0
        chunk[:take] = x[start:start + take]
        sj = _jinsert(sj, cfg_j, jnp.asarray(chunk),
                               jnp.int32(start), jnp.int32(take))
        st = tidx.insert_items(st, cfg_t, chunk, start, take)
    for leaf in ("table", "counts", "db"):
        np.testing.assert_array_equal(getattr(st, leaf).numpy(),
                                      np.asarray(getattr(sj, leaf)))
        np.testing.assert_array_equal(getattr(st, leaf).numpy(),
                                      getattr(bt, leaf).numpy())


@pytest.mark.parametrize("n_probes", [1, 4, 12])
def test_probe_stage_bit_equal(n_probes):
    cfg_j, cfg_t = _cfg()
    fam = _family(cfg_j)
    hj, pj = jidx.hash_stage(jnp.asarray(fam[0]), jnp.asarray(fam[1]),
                             cfg_j, jnp.asarray(_data(20, seed=3)))
    want = jidx.probe_stage(jnp.asarray(fam[2]), cfg_j, hj, pj, n_probes)
    _, _, mix_t = convert.family_from_numpy(*fam, device="cpu")
    got = tidx.probe_stage(mix_t, cfg_t, torch.as_tensor(np.array(hj)),
                           torch.as_tensor(np.array(pj)), n_probes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("branch", ["scatter", "sort"])
def test_dedup_candidates_equal(branch, monkeypatch):
    if branch == "sort":
        monkeypatch.setattr(jidx, "DEDUP_SCATTER_MAX_ELEMS", 1)
        monkeypatch.setattr(tidx, "DEDUP_SCATTER_MAX_ELEMS", 1)
    cfg_j, cfg_t = _cfg(cap=4)
    rng = np.random.default_rng(7)
    nq, t, n_cap = 5, 3, 40
    buckets = rng.integers(0, 4, size=(nq, cfg_j.n_tables, t))  # repeats
    cands = rng.integers(-1, n_cap, size=(nq, cfg_j.n_tables * t * 4)
                         ).astype(np.int32)
    want = jidx._dedup_candidates(jnp.asarray(cands),
                                  jnp.asarray(buckets.astype(np.int32)),
                                  cfg_j, n_cap)
    got = tidx._dedup_candidates(torch.as_tensor(cands),
                                 torch.as_tensor(buckets), cfg_t, n_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _recall(ids, exact):
    hit = (ids[:, :, None] == exact[:, None, :]) & (exact[:, None, :] >= 0)
    return float(hit.any(axis=1).mean())


@pytest.mark.parametrize("p,n_probes", [(2.0, 1), (2.0, 4), (1.0, 4)])
def test_query_index_matches_jax(p, n_probes):
    cfg_j, cfg_t = _cfg(p=p, cap=16)
    fam = _family(cfg_j, seed=11)
    x = _data(400, seed=12)
    q = x[:24] + 0.1 * _data(24, seed=13)
    _assert_equal_hashes(fam, np.concatenate([x, q]), cfg_j, cfg_t)
    sj, st = _both(cfg_j, cfg_t, fam, 512)
    sj = _jbuild(sj, cfg_j, jnp.asarray(x))
    st = tidx.build_index(st, cfg_t, x)
    live = np.ones(512, bool)
    live[::5] = False
    ij, dj = _jquery(sj, cfg=cfg_j, queries=jnp.asarray(q), k=10,
                              n_probes=n_probes, backend="reference",
                              live_mask=jnp.asarray(live))
    it, dt = tidx.query_index(st, cfg_t, q, 10, n_probes=n_probes,
                              live_mask=torch.as_tensor(live))
    ij, dj = np.asarray(ij), np.asarray(dj)
    dt = dt.numpy()
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-5, atol=1e-6)
    # distinct distances at every slot here, so the ids are equal outright
    np.testing.assert_array_equal(it.numpy(), ij)
    ej, _ = jidx.brute_force_topk(jnp.asarray(x), jnp.asarray(q), 10, p=p)
    et, edt = tidx.brute_force_topk(torch.as_tensor(x), q, 10, p=p)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    rt = float(tidx.recall_at_k(it, et))
    rj = float(jidx.recall_at_k(jnp.asarray(ij), ej))
    assert abs(rt - rj) <= 0.01
    assert abs(rt - _recall(it.numpy(), et.numpy())) < 1e-6


def test_query_index_gids_translates_and_pads():
    cfg_j, cfg_t = _cfg(cap=2)                       # few candidates: -1s
    fam = _family(cfg_j, seed=21)
    x = _data(100, seed=22)
    sj, st = _both(cfg_j, cfg_t, fam, 128)
    sj = _jbuild(sj, cfg_j, jnp.asarray(x))
    st = tidx.build_index(st, cfg_t, x)
    gids = (np.arange(128) * 3 + 1000).astype(np.int32)
    gids[100:] = -1
    gj, dj = _jquery_gids(sj, cfg=cfg_j, queries=jnp.asarray(x[:8] + 0.3),
                          k=10, gids=jnp.asarray(gids), n_probes=2,
                                   backend="reference")
    gt, dt = tidx.query_index_gids(st, cfg_t, x[:8] + 0.3, 10,
                                   torch.as_tensor(gids), n_probes=2)
    assert (gt.numpy() == -1).any()
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_make_family_shapes_and_seed():
    _, cfg_t = _cfg()
    a1 = tidx.make_family(torch.Generator().manual_seed(3), cfg_t)
    a2 = tidx.make_family(torch.Generator().manual_seed(3), cfg_t)
    for u, v in zip(a1, a2):
        assert torch.equal(u, v)
    alpha, b, mix = a1
    assert alpha.shape == (N_DIMS, 16) and b.shape == (16,)
    assert mix.dtype == torch.int64 and (mix % 2 == 1).all()
    assert ((b >= 0) & (b < 1)).all()
