"""The port's storage-tier codec and its three kernels' plain versions
(K5 quantized query, K6 rerank, K7 simhash) against the JAX package's.

Inputs are drawn with numpy and go through both packages.  Tolerances:

* int8 codes bit-equal, scales equal (a mismatch may only be a +-1 at an
  exact .5 tie of ``x / scale``, and those are counted: none expected);
* the int8 code-space top-k at p = 2 is equal, ids and distances (its sums
  are exact integers); bf16 and p = 1.5 distances allclose at rtol 1e-6,
  ids equal where distances are distinct;
* rerank distances allclose at rtol 1e-5 (the stacks sum in other orders);
* simhash bits equal except where |x @ A| < 1e-5, counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quantize as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rerank as jrerank  # noqa: E402
from repro.kernels import simhash_pack as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import (dispatch, ops, quantize,  # noqa: E402
                                 quantized_query, ref, rerank, simhash_pack)


def _t(a):
    return torch.as_tensor(np.array(a))


def _bf16_bits(codes) -> np.ndarray:
    """bf16 values of either stack as their uint16 bit patterns."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(codes).view(np.uint16)


# -- codec --------------------------------------------------------------------


@pytest.mark.parametrize("magnitude", [1e-6, 1e-2, 1.0, 1e3])
def test_int8_encode_bit_equal_to_jax(magnitude):
    rng = np.random.default_rng(int(np.log10(magnitude)) + 10)
    db = (rng.uniform(-1, 1, size=(300, 16)) * magnitude).astype(np.float32)
    codes, scale = quantize.encode(_t(db), "int8")
    cj, sj = jq.encode(jnp.asarray(db), "int8")
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == ()
    assert scale.item() == float(sj)
    diff = codes.numpy().astype(np.int32) - np.asarray(cj).astype(np.int32)
    ratio = db / np.float32(scale.item())
    at_half = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-6
    assert (np.abs(diff) <= 1).all()
    assert not (diff != 0)[~at_half].any()
    n_half_mismatch = int((diff != 0).sum())
    assert n_half_mismatch == 0, f"{n_half_mismatch} mismatches at .5 ties"
    # decode agrees too
    np.testing.assert_array_equal(quantize.decode(codes, scale).numpy(),
                                  np.asarray(jq.decode(cj, sj)))


def test_all_zero_segment_uses_unit_scale():
    codes, scale = quantize.encode(torch.zeros((5, 4)), "int8")
    assert scale.item() == 1.0
    assert not codes.any()


def test_bf16_is_a_cast_equal_to_jax():
    db = np.random.default_rng(3).normal(size=(40, 16)).astype(np.float32)
    codes, scale = quantize.encode(_t(db), "bf16")
    cj, sj = jq.encode(jnp.asarray(db), "bf16")
    assert codes.dtype == torch.bfloat16 and scale.item() == 1.0 == float(sj)
    np.testing.assert_array_equal(_bf16_bits(codes), _bf16_bits(cj))
    np.testing.assert_array_equal(quantize.decode(codes, scale).numpy(),
                                  np.asarray(jq.decode(cj, sj)))


def test_fp32_never_encodes_and_unknown_tiers_raise():
    with pytest.raises(ValueError, match="fp32"):
        quantize.encode(torch.zeros((2, 2)), "fp32")
    with pytest.raises(ValueError, match="precision"):
        quantize.storage_dtype("fp8")
    assert quantize.PRECISIONS == tuple(jq.PRECISIONS) == dispatch.STORE_DTYPES


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_bytes_per_item_and_storage_dtype(precision):
    assert quantize.bytes_per_item(precision, 64) == jq.bytes_per_item(
        precision, 64)
    assert quantize.storage_dtype(precision).itemsize == jnp.dtype(
        jq.storage_dtype(precision)).itemsize


# -- K5: code-space top-k -----------------------------------------------------


def _quantized_inputs(precision, nq, c, n, m, seed):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(m, n)).astype(np.float32)
    amax = np.abs(db).max()
    q = np.clip(db[:nq] + 0.3 * rng.normal(size=(nq, n)), -amax,
                amax).astype(np.float32)
    ids = rng.integers(-1, m, size=(nq, c)).astype(np.int32)
    cj, sj = jq.encode(jnp.asarray(db), precision)
    codes = convert.rows_from_numpy(cj, device="cpu")
    return q, ids, (codes, _t(sj).reshape(())), (cj, sj)


def _assert_topk_equal(d, i, dj, ij):
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(dj).view(np.int32))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


def _assert_topk_close(d, i, dj, ij, rtol):
    d, i, dj, ij = (np.asarray(v) for v in (d, i, dj, ij))
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], dj[fin], rtol=rtol, atol=0)
    distinct = np.ones_like(fin)
    close = np.isclose(dj[:, 1:], dj[:, :-1], rtol=1e-5, atol=0)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    np.testing.assert_array_equal(i[distinct], ij[distinct])


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("p", [2.0, 1.0, 1.5])
@pytest.mark.parametrize("valid", [None, 150])
def test_quantized_topk_plain_matches_jax(precision, p, valid):
    q, ids, (codes, scale), (cj, sj) = _quantized_inputs(
        precision, 6, 120, 24, 200, seed=int(p * 10) + (valid or 0))
    ids[0] = -1                                      # an all-invalid row
    d, i = ref.quantized_topk_ref(_t(q), codes, scale, _t(ids), 10, p=p,
                                  valid_items=valid)
    dj, ij = jq.quantized_topk_ref(jnp.asarray(q), cj, sj, jnp.asarray(ids),
                                   10, p=p, valid_items=valid)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert (i[0] == -1).all() and torch.isinf(d[0]).all()
    if precision == "int8" and p in (1.0, 2.0):
        _assert_topk_equal(d, i, dj, ij)
    else:
        _assert_topk_close(d, i, dj, ij, rtol=1e-6)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quantized_topk_plain_matches_pallas_interpret(precision):
    # nq 3 x C 50 grid steps: the interpret-mode kernel runs one Python
    # step per (row, candidate)
    q, ids, (codes, scale), (cj, sj) = _quantized_inputs(
        precision, 3, 50, 16, 80, seed=4)
    dj, ij = jq.quantized_query_topk(jnp.asarray(q), cj, sj,
                                     jnp.asarray(ids), 8, valid_items=70,
                                     interpret=True)
    d, i = ops.quantized_query_topk(_t(q), codes, scale, _t(ids), 8,
                                    valid_items=70)
    if precision == "int8":
        _assert_topk_equal(d, i, dj, ij)
    else:
        _assert_topk_close(d, i, dj, ij, rtol=1e-6)


# -- survivor rerank ----------------------------------------------------------


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_rerank_survivors_equals_jax(p):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    rows = rng.normal(size=(5, 40, 16)).astype(np.float32)
    rows[:, 20:30] = rows[:, 0:10]                   # equal distances
    gids = rng.permutation(1000)[:200].reshape(5, 40).astype(np.int32)
    gids[:, 35:] = -1
    gids[4] = -1
    g, d = quantize.rerank_survivors(_t(q), _t(rows), _t(gids), 10, p=p)
    gj, dj = jq.rerank_survivors(jnp.asarray(q), jnp.asarray(rows),
                                 jnp.asarray(gids), 10, p=p)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    assert (g[4] == -1).all()


@pytest.mark.parametrize("k,survivor_k,cap", [
    (10, 0, 10_000), (10, 64, 10_000), (10, 0, 16), (10, 500, 10_000),
    (10, 4, 10_000), (10, 0, 1024)])
def test_survivor_width_equals_jax(k, survivor_k, cap):
    assert quantize.survivor_width(k, survivor_k, cap) == jq.survivor_width(
        k, survivor_k, cap)


# -- K6: rerank distances on pre-gathered rows ------------------------------


def _rerank_inputs(b, c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n)).astype(np.float32),
            rng.normal(size=(b, c, n)).astype(np.float32),
            rng.integers(-1, 50, size=(b, c)).astype(np.int32))


@pytest.mark.parametrize("b,c,n", [(4, 16, 32), (20, 70, 64), (9, 200, 100)])
@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
def test_candidate_distances_plain_matches_jax(b, c, n, p):
    q, emb, ids = _rerank_inputs(b, c, n, seed=b + c)
    d = ops.candidate_distances(_t(q), _t(emb), _t(ids), p=p)
    want = jref.rerank_ref(jnp.asarray(q), jnp.asarray(emb),
                           jnp.asarray(ids), p)
    assert d.shape == (b, c) and d.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(d.numpy()), ids < 0)
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_candidate_distances_plain_matches_pallas_interpret(p):
    q, emb, ids = _rerank_inputs(20, 70, 64, seed=11)
    want = jrerank.rerank_distances(jnp.asarray(q), jnp.asarray(emb),
                                    jnp.asarray(ids), p=p, interpret=True)
    d = ops.candidate_distances(_t(q), _t(emb), _t(ids), p=p)
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- K7: simhash --------------------------------------------------------------


def _simhash_inputs(b, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)).astype(np.float32)
    x[0] = 0.0                                   # every projection is 0
    return x, rng.normal(size=(n, k)).astype(np.float32)


def _bits(words: np.ndarray) -> np.ndarray:
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).reshape(w.shape[0], -1)


def _assert_signature(sig, want, x, a):
    assert sig.dtype == torch.int32 and sig.shape == want.shape
    near = np.abs(x.astype(np.float64) @ a.astype(np.float64)) < 1e-5
    got_b, want_b = _bits(sig.numpy()), _bits(np.asarray(want))
    assert not (got_b != want_b)[~near].any()
    n_near_flips = int((got_b != want_b)[near].sum())
    assert n_near_flips <= int(near.sum())
    assert (sig[0] == -1).all()          # 0 >= 0 sets all 32 bits: word -1


@pytest.mark.parametrize("b,n,k", [(8, 16, 32), (64, 100, 256),
                                   (130, 64, 96)])
def test_simhash_pack_plain_matches_jax(b, n, k):
    x, a = _simhash_inputs(b, n, k, seed=b)
    sig = ops.simhash_signature(_t(x), _t(a))
    want = jref.simhash_pack_ref(jnp.asarray(x), jnp.asarray(a))
    _assert_signature(sig, want, x, a)
    assert (sig < 0).any()                       # bit 31 wraps negative


def test_simhash_pack_plain_matches_pallas_interpret():
    x, a = _simhash_inputs(130, 64, 96, seed=5)
    want = jsim.simhash_pack(jnp.asarray(x), jnp.asarray(a), interpret=True)
    _assert_signature(ops.simhash_signature(_t(x), _t(a)), want, x, a)


# -- wrappers -----------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda: quantized_query.quantized_query_topk(
        torch.zeros(2, 4), torch.zeros(5, 4, dtype=torch.int8),
        torch.ones(()), torch.zeros(2, 3, dtype=torch.int32), 2),
    lambda: rerank.rerank_distances(torch.zeros(2, 4), torch.zeros(2, 3, 4),
                                    torch.zeros(2, 3, dtype=torch.int32)),
    lambda: simhash_pack.simhash_pack(torch.zeros(2, 4), torch.zeros(4, 32)),
])
def test_new_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


def test_cpu_tensors_take_the_plain_versions():
    dispatch.reset_launches()
    q, ids, (codes, scale), _ = _quantized_inputs("int8", 2, 20, 8, 30, 0)
    ops.quantized_query_topk(_t(q), codes, scale, _t(ids), 4)
    ops.candidate_distances(_t(q), torch.zeros(2, 20, 8), _t(ids))
    ops.simhash_signature(_t(q), torch.zeros(8, 32))
    assert all(v == 0 for v in dispatch.launches.values())
