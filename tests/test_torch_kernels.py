"""The port's plain kernel versions against the JAX package's.

Each plain PyTorch version in ``repro_torch.kernels.ref`` takes the same
numpy inputs as its JAX counterpart (``repro.kernels.ref`` and
``repro.kernels.merge``) and, at tiny shapes, as the Pallas kernel run in
interpret mode.  Tolerances: matmul outputs are allclose (the two stacks
sum in different orders), integer hashes are equal away from a bucket
boundary, top-k ids are equal where distances are distinct, and the merge
network is bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dct_mm as jdct  # noqa: E402
from repro.kernels import fused_query as jfused  # noqa: E402
from repro.kernels import hash_mm as jhash  # noqa: E402
from repro.kernels import merge as jmerge  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import (dct_mm, dispatch, fused_query,  # noqa: E402
                                 hash_mm, merge, ops, ref, rerank)

BOUNDARY = 1e-4   # |proj - round(proj)| below this may floor either way


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _hash_inputs(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, n)).astype(np.float32) * 0.5,
            rng.normal(size=(n, k)).astype(np.float32),
            rng.uniform(size=(k,)).astype(np.float32))


def _assert_hashes(h, proj, h_ref, proj_ref):
    np.testing.assert_allclose(proj, proj_ref, rtol=1e-6, atol=1e-5)
    safe = np.abs(proj_ref - np.round(proj_ref)) > BOUNDARY
    np.testing.assert_array_equal(h[safe], h_ref[safe])


@pytest.mark.parametrize("m,n,k", [(8, 64, 32), (33, 50, 17), (256, 64, 32)])
def test_hash_mm_plain_matches_jax(m, n, k):
    x, a, b = _hash_inputs(m, n, k)
    h, p = ref.hash_mm_proj_ref(_t(x), _t(a), _t(b), 4.0)
    hj, pj = jref.hash_mm_proj_ref(jnp.asarray(x), jnp.asarray(a),
                                   jnp.asarray(b), 4.0)
    assert h.dtype == torch.int32 and p.dtype == torch.float32
    _assert_hashes(h.numpy(), p.numpy(), np.asarray(hj), np.asarray(pj))


def test_hash_mm_plain_matches_pallas_interpret():
    x, a, b = _hash_inputs(8, 64, 32, seed=1)
    hj, pj = jhash.hash_mm(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                           4.0, bm=8, bk=32, bn=64, interpret=True,
                           return_proj=True)
    h, p = ops.pstable_hash_proj(_t(x), _t(a), _t(b), 4.0)
    _assert_hashes(h.numpy(), p.numpy(), np.asarray(hj), np.asarray(pj))


def _dct_inputs(m, n, seed=0):
    from repro_torch.embedders.basis import cheb_kernel_constants
    rng = np.random.default_rng(seed)
    pre, mat, scale = cheb_kernel_constants(n, (-1.0, 1.0), "lebesgue")
    return (rng.normal(size=(m, n)).astype(np.float32) * pre, mat, scale)


@pytest.mark.parametrize("m,n", [(4, 32), (128, 64), (100, 129)])
def test_dct_mm_plain_matches_jax(m, n):
    f, mat, scale = _dct_inputs(m, n)
    out = ref.dct_mm_ref(_t(f), _t(mat), _t(scale))
    want = jref.dct_mm_ref(jnp.asarray(f), jnp.asarray(mat),
                           jnp.asarray(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_dct_mm_plain_matches_pallas_interpret():
    f, mat, scale = _dct_inputs(8, 64, seed=2)
    want = jdct.dct_mm(jnp.asarray(f), jnp.asarray(mat), jnp.asarray(scale),
                       bm=8, bk=64, bn=64, interpret=True)
    out = ops.cheb_embed(_t(f), _t(mat), _t(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _fused_inputs(nq, c, n, m, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, n)).astype(np.float32)
    db = rng.normal(size=(m, n)).astype(np.float32)
    ids = rng.integers(-1, m, size=(nq, c)).astype(np.int32)
    return q, db, ids


def _assert_topk(d, i, dj, ij):
    d, i, dj, ij = (np.asarray(v) for v in (d, i, dj, ij))
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], dj[fin], rtol=1e-5, atol=1e-6)
    # ids must agree wherever the reference distance is distinct from its
    # neighbours (a tie may be broken either way by a rounding difference)
    distinct = np.ones_like(fin)
    close = np.isclose(dj[:, 1:], dj[:, :-1], rtol=1e-5, atol=0)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    np.testing.assert_array_equal(i[distinct], ij[distinct])


@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("valid", [None, 60])
def test_fused_query_plain_matches_jax(p, valid):
    q, db, ids = _fused_inputs(6, 80, 24, 100)
    ids[0] = -1                                     # an all-invalid row
    d, i = ref.fused_query_topk_ref(_t(q), _t(db), _t(ids), 7, p=p,
                                    valid_items=valid)
    dj, ij = jref.fused_query_topk_ref(jnp.asarray(q), jnp.asarray(db),
                                       jnp.asarray(ids), 7, p=p,
                                       valid_items=valid)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert (i[0] == -1).all() and torch.isinf(d[0]).all()
    _assert_topk(d, i, dj, ij)


def test_fused_query_plain_ties_take_the_lower_slot():
    # equal distances: lax.top_k puts the lower slot first, and so must the
    # plain version (torch.topk promises no order)
    db = np.zeros((4, 8), np.float32)
    q = np.zeros((1, 8), np.float32)
    ids = np.array([[3, 1, 2, 0, 1]], np.int32)
    d, i = ref.fused_query_topk_ref(_t(q), _t(db), _t(ids), 5)
    dj, ij = jref.fused_query_topk_ref(jnp.asarray(q), jnp.asarray(db),
                                       jnp.asarray(ids), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_fused_query_plain_matches_pallas_interpret(p):
    q, db, ids = _fused_inputs(3, 40, 16, 50, seed=3)
    dj, ij = jfused.fused_query_topk(jnp.asarray(q), jnp.asarray(db),
                                     jnp.asarray(ids), 5, p=p,
                                     valid_items=45, interpret=True)
    d, i = ops.fused_query_topk(_t(q), _t(db), _t(ids), 5, p=p,
                                valid_items=45)
    _assert_topk(d, i, dj, ij)


def _pairs(rows, width, seed):
    rng = np.random.default_rng(seed)
    d = np.round(rng.uniform(size=(rows, width)) * 20) / 20   # many ties
    d[:, ::7] = np.inf
    i = rng.integers(-1, 3 * width + 2, size=(rows, width))
    return d.astype(np.float32), i.astype(np.int32)


def _assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("width", [1, 3, 8, 13, 64, 100, 257])
def test_sort_pairs_bit_identical_to_jax_network(width):
    d, i = _pairs(4, width, width)
    ds, is_ = ref.sort_pairs(_t(d), _t(i))
    dj, ij = jmerge.sort_pairs(jnp.asarray(d), jnp.asarray(i))
    _assert_bits(ds.numpy(), dj)
    _assert_bits(is_.numpy(), ij)
    # and the network is the lexicographic sort: stable by id, then by
    # distance
    o = np.argsort(i, axis=-1, kind="stable")
    d1, i1 = np.take_along_axis(d, o, -1), np.take_along_axis(i, o, -1)
    o2 = np.argsort(d1, axis=-1, kind="stable")
    _assert_bits(ds.numpy(), np.take_along_axis(d1, o2, -1))
    _assert_bits(is_.numpy(), np.take_along_axis(i1, o2, -1))


def test_sort_pairs_above_the_old_pool_cap_matches_jax():
    """A row of 20,000 pairs (padded to 32,768), past the 16,384 that the
    card's network route holds in shared memory: the reference answers, so
    the port's fan-in must too (the select route, on the card)."""
    d, i = _pairs(2, 20_000, 16385)
    ds, is_ = ref.sort_pairs(_t(d), _t(i))
    dj, ij = jmerge.sort_pairs(jnp.asarray(d), jnp.asarray(i))
    _assert_bits(ds.numpy(), dj)
    _assert_bits(is_.numpy(), ij)
    sd, si = ops.merge_topk(_t(d), _t(i), 40)
    dj, ij = jops.merge_topk(jnp.asarray(d), jnp.asarray(i), 40,
                             mode="bitonic")
    _assert_bits(sd.numpy(), dj)
    _assert_bits(si.numpy(), ij)


def test_sort_pairs_sorted_run_matches_jax():
    d, i = _pairs(3, 64, 5)
    order = np.lexsort((i.reshape(3, 8, 8), d.reshape(3, 8, 8)), axis=-1)
    d = np.take_along_axis(d.reshape(3, 8, 8), order, -1).reshape(3, 64)
    i = np.take_along_axis(i.reshape(3, 8, 8), order, -1).reshape(3, 64)
    ds, is_ = ref.sort_pairs(_t(d), _t(i), sorted_run=8)
    dj, ij = jmerge.sort_pairs(jnp.asarray(d), jnp.asarray(i), sorted_run=8)
    _assert_bits(ds.numpy(), dj)
    _assert_bits(is_.numpy(), ij)


def test_sort_pairs_plain_matches_pallas_interpret():
    d, i = _pairs(3, 24, 9)
    dj, ij = jmerge.sort_pairs_pallas(jnp.asarray(d), jnp.asarray(i),
                                      interpret=True)
    ds, is_ = ref.sort_pairs(_t(d), _t(i))
    _assert_bits(ds.numpy(), dj)
    _assert_bits(is_.numpy(), ij)


@pytest.mark.parametrize("width,k", [(30, 10), (4, 10), (10, 10)])
def test_merge_topk_matches_jax(width, k):
    d, i = _pairs(5, width, 100 + width)
    sd, si = ops.merge_topk(_t(d), _t(i), k)
    dj, ij = jops.merge_topk(jnp.asarray(d), jnp.asarray(i), k,
                             mode="bitonic")
    _assert_bits(sd.numpy(), dj)
    _assert_bits(si.numpy(), ij)


# The ROADMAP's probe row: -0.0 sorted below +0.0 would give ids [3, 5, 9,
# 1]; the network calls them equal and breaks the tie by id.
PROBE_D = [[0.0, -0.0, 0.0, -0.0, 1.0, 2.0, -0.0, 0.0]]
PROBE_I = [[7, 3, 1, 5, 0, 2, 9, 4]]


def _signed_zero_pairs(rows, width, seed):
    """Half the distances +0.0 or -0.0, the rest as _pairs draws them."""
    d, i = _pairs(rows, width, seed)
    pick = np.random.default_rng(seed + 1).integers(0, 4, size=d.shape)
    d = np.where(pick == 0, np.float32(-0.0), np.where(pick == 1, 0.0, d))
    return d.astype(np.float32), i


@pytest.mark.parametrize("case", ["probe", 8, 40, 257])
def test_merge_topk_orders_signed_zeros_as_jax_bitonic(case):
    if case == "probe":
        d, i = np.array(PROBE_D, np.float32), np.array(PROBE_I, np.int32)
        k = 4
    else:
        d, i = _signed_zero_pairs(4, case, seed=case)
        k = min(case, 10)
    sd, si = ops.merge_topk(_t(d), _t(i), k)
    dj, ij = jops.merge_topk(jnp.asarray(d), jnp.asarray(i), k,
                             mode="bitonic")
    _assert_bits(sd.numpy(), dj)
    _assert_bits(si.numpy(), ij)
    ds, is_ = ref.sort_pairs(_t(d), _t(i))
    dj, ij = jmerge.sort_pairs(jnp.asarray(d), jnp.asarray(i))
    _assert_bits(ds.numpy(), dj)
    _assert_bits(is_.numpy(), ij)
    if case == "probe":
        assert si.tolist() == [[1, 3, 4, 5]]


def _select_keys(d, i):
    """csrc/merge.cu's encode in numpy: the float's order bits (negated
    when the sign is set, which sends -0.0 to +0.0's word, else the sign
    bit set) above id ^ 0x80000000, as uint64."""
    b = d.view(np.uint32).astype(np.uint64)
    hi = np.where(b & 0x80000000, (2 ** 32 - b) & 0xFFFFFFFF, b | 0x80000000)
    lo = (i.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize("case", ["probe", 8, 40, 257])
def test_select_route_key_order_is_the_networks_on_signed_zeros(case):
    """K3's select route sorts by its 64-bit keys: on rows of mixed +0.0 and
    -0.0 the key order gives the network's ids, and its distances as
    values (a -0.0 decodes as +0.0)."""
    if case == "probe":
        d, i = np.array(PROBE_D, np.float32), np.array(PROBE_I, np.int32)
    else:
        d, i = _signed_zero_pairs(4, case, seed=case)
    order = np.argsort(_select_keys(d, i), axis=-1, kind="stable")
    ds, is_ = ref.sort_pairs(_t(d), _t(i))
    np.testing.assert_array_equal(np.take_along_axis(i, order, -1),
                                  is_.numpy())
    np.testing.assert_array_equal(np.take_along_axis(d, order, -1),
                                  ds.numpy())


def test_cpu_tensors_take_the_plain_versions():
    dispatch.reset_launches()
    x, a, b = _hash_inputs(8, 16, 8)
    ops.pstable_hash_proj(_t(x), _t(a), _t(b), 1.0)
    d, i = _pairs(2, 12, 0)
    ops.merge_topk(_t(d), _t(i), 4)
    assert all(v == 0 for v in dispatch.launches.values())


@pytest.mark.parametrize("call", [
    lambda: hash_mm.hash_mm(torch.zeros(2, 4), torch.zeros(4, 3),
                            torch.zeros(3), 1.0),
    lambda: dct_mm.dct_mm(torch.zeros(2, 4), torch.zeros(4, 4),
                          torch.zeros(4)),
    lambda: fused_query.fused_query_topk(
        torch.zeros(2, 4), torch.zeros(5, 4),
        torch.zeros(2, 3, dtype=torch.int32), 2),
    lambda: merge.sort_pairs_kernel(torch.zeros(2, 4),
                                    torch.zeros(2, 4, dtype=torch.int32)),
    lambda: merge.sort_pairs_kernel(torch.zeros(2, 400),
                                    torch.zeros(2, 400, dtype=torch.int32),
                                    n_out=10),
    lambda: merge.merge_topk_kernel(torch.zeros(2, 4),
                                    torch.zeros(2, 4, dtype=torch.int32), 2),
    lambda: rerank.rerank_distances(torch.zeros(2, 4), torch.zeros(2, 3, 4),
                                    torch.zeros(2, 3, dtype=torch.int32)),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


def test_resolve_device(monkeypatch):
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    # "meta" sizes the dry run's cells (shapes, no memory)
    assert dispatch.resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        dispatch.resolve_device("xpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch.resolve_device(dev)
