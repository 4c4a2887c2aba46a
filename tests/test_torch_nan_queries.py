"""Query rows holding a NaN or an infinity, on the CPU and on the card.

The port's answer, pinned: a row with a NaN, +inf or -inf entry gets gid
-1 and distance +inf in every slot, and every other row of the batch gets
the bits it gets when the bad rows hold finite values instead.  Checked at
fp32, bf16 and int8, at 1 and 4 probes, through ``SegmentedIndex.query``
(the stacked query), ``_query_fanout`` (the per-segment reference) and
``Servable.query`` (the micro-batcher).  No kernel entry point -- K1's
hash, K2, K5, K6 and K3's merge -- receives a NaN: each is wrapped to
check its float arguments.

The JAX package is not the reference here: its int8 tier returns NaN-
distance gids ahead of its ``(+inf, -1)`` padding (ROADMAP queue 3).

The ``cuda``-marked test builds the same index on the card and requires
the card's bad rows to equal the CPU's, (-1, +inf), bit for bit, and the
other rows to keep the card's bits for the batch without the bad values.
It skips without a card.  The file imports no jax, so the card's machine
can run it with ``--noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (SegmentedIndex, ServableRegistry,  # noqa: E402
                               ServableSpec)

N_DIMS = 16
BAD = {1: np.nan, 4: np.inf, 5: -np.inf}     # row -> the value put in it
ENTRY_POINTS = ("pstable_hash_proj", "fused_query_topk",
                "quantized_query_topk", "candidate_distances", "merge_topk")


def _cfg(p=2.0):
    return tidx.IndexConfig(n_dims=N_DIMS, n_tables=4, n_hashes=4,
                            log2_buckets=8, bucket_capacity=64, r=2.0, p=p)


def _family():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(N_DIMS, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.int64))


def _data(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _index(precision, device="cpu", p=2.0):
    idx = SegmentedIndex(_cfg(p), segment_capacity=128, insert_chunk=64,
                         family=tuple(torch.as_tensor(a) for a in _family()),
                         precision=precision, device=device)
    g = idx.insert(_data(300, seed=1))     # two sealed segments + a delta
    idx.delete(g[::7])
    return idx


def _batches():
    """(bad batch, the same batch with finite rows where it is bad)."""
    q = _data(8, seed=2, scale=0.9)
    clean = q.copy()
    clean[list(BAD)] = _data(len(BAD), seed=3)
    for r, v in BAD.items():
        q[r, r % N_DIMS] = v
    q[6, :] = np.nan                       # a row of nothing but NaN
    clean[6] = _data(1, seed=4)[0]
    return q, clean


def _np(pair):
    g, d = pair
    return np.asarray(g.cpu() if hasattr(g, "cpu") else g), \
        np.asarray(d.cpu() if hasattr(d, "cpu") else d)


@pytest.fixture
def no_nan_reaches_a_kernel(monkeypatch):
    """Wrap every kernel entry point to refuse a NaN float argument."""
    seen = []

    def wrap(name, fn):
        def checked(*args, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    assert not bool(torch.isnan(a).any()), \
                        f"{name} received a NaN"
            seen.append(name)
            return fn(*args, **kw)
        return checked

    for name in ENTRY_POINTS:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    return seen


def _check(got, want, bad_rows):
    g, d = got
    wg, wd = want
    good = np.setdiff1d(np.arange(g.shape[0]), bad_rows)
    assert (g[bad_rows] == -1).all()
    assert np.isposinf(d[bad_rows]).all()
    np.testing.assert_array_equal(g[good], wg[good])
    np.testing.assert_array_equal(d[good].view(np.uint32),
                                  wd[good].view(np.uint32))
    assert (g[good, 0] >= 0).all()          # the good rows found items


BAD_ROWS = sorted(list(BAD) + [6])


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n_probes", [1, 4])
@pytest.mark.parametrize("path", ["query", "fanout"])
def test_non_finite_rows_answer_minus_one_inf(precision, n_probes, path,
                                              no_nan_reaches_a_kernel):
    idx = _index(precision)
    q, clean = _batches()
    fn = idx.query if path == "query" else idx._query_fanout
    _check(_np(fn(q, 10, n_probes=n_probes)),
           _np(fn(clean, 10, n_probes=n_probes)), BAD_ROWS)
    assert "merge_topk" in no_nan_reaches_a_kernel
    if precision == "int8":
        assert "quantized_query_topk" in no_nan_reaches_a_kernel
        assert "candidate_distances" in no_nan_reaches_a_kernel


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_non_finite_rows_through_the_batcher(precision,
                                             no_nan_reaches_a_kernel):
    sv = ServableRegistry(device="cpu").register(ServableSpec(
        name="t", n_dims=N_DIMS, r=2.0, n_tables=4, log2_buckets=8,
        bucket_capacity=64, segment_capacity=128, insert_chunk=64,
        chunk_sizes=(8, 32), precision=precision))
    sv.insert(_data(300, seed=1))
    q, clean = _batches()
    _check(sv.query(q, 10, 4), sv.query(clean, 10, 4), BAD_ROWS)


def test_p1_and_an_all_bad_batch(no_nan_reaches_a_kernel):
    idx = _index("int8", p=1.0)
    q, clean = _batches()
    _check(_np(idx.query(q, 5, n_probes=2)),
           _np(idx.query(clean, 5, n_probes=2)), BAD_ROWS)
    g, d = _np(idx.query(np.full((3, N_DIMS), np.nan, np.float32), 5))
    assert (g == -1).all() and np.isposinf(d).all()


def test_an_empty_index_answers_bad_rows_alike():
    idx = SegmentedIndex(_cfg(), segment_capacity=128, device="cpu")
    q, _ = _batches()
    g, d = _np(idx.query(q, 4))
    assert (g == -1).all() and np.isposinf(d).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_card_answers_non_finite_rows_as_the_cpu(precision,
                                                 no_nan_reaches_a_kernel):
    """On the card the bad rows answer (-1, +inf) as on the CPU, and the
    other rows keep the card's own bits for the batch with finite rows in
    their place (card against CPU on finite rows is the chip smoke's
    phase 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, clean = _batches()
    cpu, card = _index(precision), _index(precision, device="cuda")
    for n_probes in (1, 4):
        got = _np(card.query(q, 10, n_probes=n_probes))
        _check(got, _np(card.query(clean, 10, n_probes=n_probes)), BAD_ROWS)
        want = _np(cpu.query(q, 10, n_probes=n_probes))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[BAD_ROWS], b[BAD_ROWS])
        _check(_np(card._query_fanout(q, 10, n_probes=n_probes)),
               _np(card._query_fanout(clean, 10, n_probes=n_probes)),
               BAD_ROWS)
    assert "merge_topk" in no_nan_reaches_a_kernel
