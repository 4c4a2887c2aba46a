"""The port's ``query_index_batched`` against the JAX package's, on the CPU.

Mirrors ``tests/test_fused_query.py``'s batched-query tests for
``repro_torch.core.index.query_index_batched``: a query set tiled into
fixed ``batch_size`` chunks (the last one zero-padded and its padding rows
sliced off) answers as one ``query_index`` call over the same rows -- bit
for bit within the port (ids and distance bits) -- and as the JAX
package's ``query_index_batched`` on the same state under the parity
contract: ids equal where the JAX distances are distinct, distances
``rtol=1e-6, atol=1e-6``.  Shapes: a ragged last chunk, an all-zero real
row inside it, fewer rows than one chunk, exactly one chunk, an empty
index, a live mask.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402

CFG = dict(n_dims=32, n_tables=4, n_hashes=4, log2_buckets=9,
           bucket_capacity=16, r=2.0)
N_ITEMS = 512


def _state(build=True):
    """The same built index in both packages (the JAX state converted)."""
    cfg_j = jidx.IndexConfig(**CFG)
    sj = jidx.create_index(jax.random.PRNGKey(0), cfg_j, N_ITEMS)
    if build:
        db = np.random.default_rng(0).normal(size=(N_ITEMS, 32)).astype(
            np.float32)
        sj = jax.jit(jidx.build_index, static_argnums=1)(sj, cfg_j,
                                                         jnp.asarray(db))
    st = convert.state_from_numpy(*(np.asarray(leaf) for leaf in (
        sj.alpha, sj.b, sj.mix, sj.table, sj.counts, sj.db)), device="cpu")
    return cfg_j, sj, tidx.IndexConfig(**CFG), st


def _queries(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32)).astype(
        np.float32)


def _check(q, k, batch_size, n_probes=2, build=True, mask=None):
    cfg_j, sj, cfg_t, st = _state(build)
    kw = dict(n_probes=n_probes)
    one_i, one_d = tidx.query_index(st, cfg_t, q, k, live_mask=mask, **kw)
    bi, bd = tidx.query_index_batched(st, cfg_t, q, k,
                                      batch_size=batch_size, live_mask=mask,
                                      **kw)
    assert bi.shape == (q.shape[0], k) and bd.shape == (q.shape[0], k)
    np.testing.assert_array_equal(bi.numpy(), one_i.numpy())
    np.testing.assert_array_equal(bd.numpy().view(np.uint32),
                                  one_d.numpy().view(np.uint32))
    jm = None if mask is None else jnp.asarray(mask.numpy())
    ji, jd = lidx_batched(sj, cfg_j, q, k, batch_size, jm, **kw)
    np.testing.assert_allclose(bd.numpy(), jd, rtol=1e-6, atol=1e-6)
    for r in range(ji.shape[0]):
        d = jd[r]
        with np.errstate(invalid="ignore"):      # inf - inf past the hits
            step = np.diff(d) > 0
        distinct = np.isfinite(d) & np.r_[True, step] & np.r_[step, True]
        np.testing.assert_array_equal(bi.numpy()[r][distinct],
                                      ji[r][distinct])
        assert ((bi.numpy()[r] < 0) == (ji[r] < 0)).all()
    return bi.numpy(), bd.numpy()


def lidx_batched(sj, cfg_j, q, k, batch_size, mask, n_probes):
    ji, jd = jidx.query_index_batched(sj, cfg_j, jnp.asarray(q), k,
                                      n_probes=n_probes,
                                      batch_size=batch_size,
                                      backend="reference", live_mask=mask)
    return np.asarray(ji), np.asarray(jd)


def test_batched_query_matches_unbatched():
    _check(_queries(37, 3), 5, batch_size=16)


def test_batched_query_ragged_last_chunk():
    """nq not a multiple of batch_size: the padded tail's rows neither leak
    nor change the real rows; an all-zero real row in it still answers."""
    q = _queries(21, 4)
    _check(q, 5, batch_size=8)
    q[20] = 0.0
    _check(q, 5, batch_size=8)


@pytest.mark.parametrize("n,batch_size", [(3, 64), (16, 16)])
def test_batched_query_at_most_one_chunk(n, batch_size):
    """nq <= batch_size is one query_index call, shapes intact."""
    _check(_queries(n, 5 + n), 5, batch_size=batch_size)


def test_batched_query_empty_index():
    """No item in any bucket: every slot (-1, +inf) in both packages."""
    for bs in (8, 64):
        bi, bd = _check(_queries(21, 7), 5, batch_size=bs, build=False)
        assert (bi == -1).all() and np.isinf(bd).all()


def test_batched_query_live_mask():
    dead = np.zeros(N_ITEMS, bool)
    dead[::3] = True
    mask = torch.as_tensor(~dead)
    for bs in (8, 64):
        bi, _ = _check(_queries(21, 8), 5, batch_size=bs, mask=mask)
        assert not np.isin(bi[bi >= 0], np.flatnonzero(dead)).any()


def test_batched_query_launch_shapes(monkeypatch):
    """Every chunk reaches the index at batch_size rows (K1 and K2 see one
    shape), the last one zero-padded."""
    _, _, cfg_t, st = _state()
    seen = []
    real = tidx.query_index

    def spy(state, cfg, queries, *a, **kw):
        seen.append(tuple(queries.shape))
        return real(state, cfg, queries, *a, **kw)
    monkeypatch.setattr(tidx, "query_index", spy)
    tidx.query_index_batched(st, cfg_t, _queries(50, 9), 5, batch_size=16)
    assert seen == [(16, 32)] * 4
