"""The port's hash families (``repro_torch.core.hashes``) and hashing ops
against the JAX package's, on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
packages (the JAX ``alpha`` reaches the port through ``convert.py``).
Tolerances: signature bits equal wherever |x @ alpha| >= 1e-5 (a sum
within 1e-5 of 0 may take either sign in another summation order; those
cases are counted), Hamming distances exact, p-stable projections rtol
1e-6 atol 1e-5 and hashes equal away from a floor boundary
(|proj - round(proj)| > 1e-4, counted), as the ROADMAP's parity contract.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashes as jhashes  # noqa: E402
from repro.kernels import hash_mm as jhash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import simhash_pack as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import hashes  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

NEAR = 1e-5        # |x @ alpha| below this may take either sign
BOUNDARY = 1e-4    # |proj - round(proj)| below this may floor either way


def _unpack(words) -> np.ndarray:
    """(..., W) int32 words -> (..., 32 W) bits, bit j of word w at 32w+j."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).reshape(*w.shape[:-1], -1)


def _simhash_inputs(lead, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=tuple(lead) + (n,)).astype(np.float32)
    x.reshape(-1, n)[0] = 0.0                 # every projection is 0
    return x, rng.normal(size=(n, k)).astype(np.float32)


def _assert_bits_match(got_bits, want_bits, x, alpha):
    """Bits equal wherever |x @ alpha| >= NEAR; returns the near cases."""
    near = np.abs(x.astype(np.float64) @ alpha.astype(np.float64)) < NEAR
    assert got_bits.shape == want_bits.shape == near.shape
    assert not (got_bits != want_bits)[~near].any()
    return int(near.sum())


@pytest.mark.parametrize("lead", [(9,), (3, 5)])
@pytest.mark.parametrize("n", [16, 64, 100])
@pytest.mark.parametrize("k", [32, 96, 100, 256])
def test_simhash_call_matches_jax(lead, n, k):
    x, alpha = _simhash_inputs(lead, n, k, seed=n + k)
    fam = convert.simhash_from_numpy(alpha, device="cpu")
    sig = fam(torch.as_tensor(x))
    want = np.asarray(jhashes.SimHash(alpha=jnp.asarray(alpha))(
        jnp.asarray(x)))
    words = -(-k // 32)
    assert sig.dtype == torch.int32 and want.dtype == np.int32
    assert tuple(sig.shape) == want.shape == tuple(lead) + (words,)
    got_b, want_b = _unpack(sig.numpy()), _unpack(want)
    n_near = _assert_bits_match(got_b[..., :k], want_b[..., :k], x, alpha)
    assert n_near >= k                  # the zero row: all its projections
    # the pad bits past K are clear in both
    assert not got_b[..., k:].any() and not want_b[..., k:].any()
    zero = sig.reshape(-1, words)[0]
    if k % 32 == 0:
        assert (zero == -1).all()
    else:
        assert (zero[:-1] == -1).all()
        assert int(zero[-1]) == (1 << (k % 32)) - 1
    assert (sig < 0).any()              # bit 31 wraps negative, as in JAX


@pytest.mark.parametrize("k", [32, 100])
def test_simhash_bits_match_jax(k):
    x, alpha = _simhash_inputs((2, 6), 64, k, seed=k)
    got = hashes.SimHash(alpha=torch.as_tensor(alpha)).bits(
        torch.as_tensor(x))
    want = np.asarray(jhashes.SimHash(alpha=jnp.asarray(alpha)).bits(
        jnp.asarray(x)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    _assert_bits_match(got.numpy(), want, x, alpha)
    # bits are the signature's, unpacked
    sig = hashes.SimHash(alpha=torch.as_tensor(alpha))(torch.as_tensor(x))
    np.testing.assert_array_equal(_unpack(sig.numpy())[..., :k],
                                  got.numpy())


@pytest.mark.parametrize("shape", [(5, 4), (2, 3, 7), (1, 1)])
def test_simhash_hamming_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    b = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    a, b = a.astype(np.int32), b.astype(np.int32)
    a.reshape(-1)[0] = -1                  # all 32 bits differ from 0
    b.reshape(-1)[0] = 0
    got = hashes.SimHash.hamming(torch.as_tensor(a), torch.as_tensor(b))
    want = np.asarray(jhashes.SimHash.hamming(jnp.asarray(a),
                                              jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), (_unpack(a) != _unpack(b)).sum(axis=-1))


def test_simhash_hamming_of_signatures_counts_sign_flips():
    x, alpha = _simhash_inputs((6,), 64, 96, seed=2)
    fam = convert.simhash_from_numpy(alpha, device="cpu")
    xt = torch.as_tensor(x[1:])
    d = hashes.SimHash.hamming(fam(xt), fam(-xt))
    near = (np.abs(x[1:].astype(np.float64) @ alpha) < NEAR).sum(axis=-1)
    # x and -x agree only where a projection is 0
    assert ((d.numpy() >= 96 - near) & (d.numpy() <= 96)).all()


def test_simhash_create_draws_from_the_generator():
    fam = hashes.SimHash.create(torch.Generator().manual_seed(7), 64, 1024)
    again = hashes.SimHash.create(torch.Generator().manual_seed(7), 64, 1024)
    assert fam.alpha.shape == (64, 1024) and fam.alpha.dtype == torch.float32
    assert fam.alpha.device.type == "cpu"
    assert torch.equal(fam.alpha, again.alpha)
    assert abs(float(fam.alpha.mean())) < 0.01
    assert abs(float(fam.alpha.std()) - 1.0) < 0.01


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.int32])
def test_simhash_refuses_other_dtypes(dtype):
    fam = hashes.SimHash.create(torch.Generator().manual_seed(0), 8, 32)
    with pytest.raises(ValueError, match=str(dtype)):
        fam(torch.zeros((2, 8), dtype=dtype))


def test_simhash_on_cpu_tensors_takes_the_plain_version():
    dispatch.reset_launches()
    fam = hashes.SimHash.create(torch.Generator().manual_seed(0), 16, 100)
    fam(torch.randn(4, 16))
    fam.bits(torch.randn(2, 3, 16))
    assert all(v == 0 for v in dispatch.launches.values())


def test_simhash_from_numpy():
    alpha = np.random.default_rng(0).normal(size=(16, 64))
    fam = convert.simhash_from_numpy(alpha, device="cpu")
    assert isinstance(fam, hashes.SimHash)
    assert fam.alpha.dtype == torch.float32 and fam.alpha.is_contiguous()
    np.testing.assert_array_equal(fam.alpha.numpy(),
                                  alpha.astype(np.float32))


# -- the kernel's own arithmetic --------------------------------------------


def _nearest(v: Fraction, r: float) -> bool:
    """True when fp32 ``r`` is a nearest fp32 to the exact value ``v``."""
    r32 = np.float32(r)
    up = np.nextafter(r32, np.float32(np.inf))
    down = np.nextafter(r32, np.float32(-np.inf))
    e = abs(v - Fraction(float(r32)))
    return e <= abs(v - Fraction(float(up))) and \
        e <= abs(v - Fraction(float(down)))


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = (rng.normal(size=2000) * 2.0 ** rng.integers(-30, 30, 2000)).astype(
        np.float32)
    r = ref.fma32(*(torch.as_tensor(t) for t in (a, b, c))).numpy()
    for ai, bi, ci, ri in zip(a, b, c, r):
        v = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        assert _nearest(v, ri)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma32_where_float64_rounds_twice(sign):
    """a * b + c = c + 2^-24 - 2^-70 with c = 1 + 2^-23: float64 rounds it
    to the midpoint c + 2^-24, which rounds to even (1 + 2^-22); the exact
    value lies below the midpoint, so fmaf gives c."""
    a = torch.tensor([sign * 2.0 ** -12 * (1 + 2.0 ** -23)])
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23)])
    c = torch.tensor([sign * (1 + 2.0 ** -23)])
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == sign * (1 + 2.0 ** -22)
    assert ref.fma32(a, b, c).item() == sign * (1 + 2.0 ** -23)


@pytest.mark.parametrize("b,n,k", [(8, 16, 32), (37, 50, 96)])
def test_simhash_chain_matches_plain_and_pallas(b, n, k):
    x, alpha = _simhash_inputs((b,), n, k, seed=b)
    xt, at = torch.as_tensor(x), torch.as_tensor(alpha)
    chain = ref.simhash_pack_chain_ref(xt, at)
    assert chain.dtype == torch.int32 and chain.shape == (b, k // 32)
    _assert_bits_match(_unpack(chain.numpy()),
                       _unpack(ref.simhash_pack_ref(xt, at).numpy()), x,
                       alpha)
    want = jsim.simhash_pack(jnp.asarray(x), jnp.asarray(alpha),
                             interpret=True)
    _assert_bits_match(_unpack(chain.numpy()), _unpack(want), x, alpha)
    assert (chain[0] == -1).all()


# -- p-stable ---------------------------------------------------------------


def _pstable_inputs(lead, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=tuple(lead) + (n,)).astype(np.float32) * 0.5,
            rng.normal(size=(n, k)).astype(np.float32),
            rng.uniform(size=(k,)).astype(np.float32))


def _assert_hashes(h, proj, h_ref, proj_ref):
    """Projections close; hashes equal away from a floor boundary.
    Returns the number of boundary cases."""
    np.testing.assert_allclose(proj, proj_ref, rtol=1e-6, atol=1e-5)
    safe = np.abs(proj_ref - np.round(proj_ref)) > BOUNDARY
    np.testing.assert_array_equal(h[safe], h_ref[safe])
    return int((~safe).sum())


@pytest.mark.parametrize("m,n,k,r", [(8, 64, 32, 4.0), (33, 50, 17, 1.0),
                                     (128, 64, 32, 2.5)])
def test_pstable_hash_matches_jax(m, n, k, r):
    x, a, b = _pstable_inputs((m,), n, k, seed=m)
    h = ops.pstable_hash(*(torch.as_tensor(t) for t in (x, a, b)), r)
    jargs = (jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), r)
    hj = np.asarray(jops.pstable_hash(*jargs, use_kernel=False))
    _, pj = jops.pstable_hash_proj(*jargs, use_kernel=False)
    assert h.dtype == torch.int32 and h.shape == (m, k)
    safe = np.abs(np.asarray(pj) - np.round(np.asarray(pj))) > BOUNDARY
    np.testing.assert_array_equal(h.numpy()[safe], hj[safe])
    assert int((h.numpy() != hj).sum()) <= int((~safe).sum())


def test_pstable_hash_matches_pallas_interpret():
    x, a, b = _pstable_inputs((8,), 64, 32, seed=3)
    hj, pj = jhash.hash_mm(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                           4.0, bm=8, bk=32, bn=64, interpret=True,
                           return_proj=True)
    h = ops.pstable_hash(*(torch.as_tensor(t) for t in (x, a, b)), 4.0)
    safe = np.abs(np.asarray(pj) - np.round(np.asarray(pj))) > BOUNDARY
    np.testing.assert_array_equal(h.numpy()[safe], np.asarray(hj)[safe])


@pytest.mark.parametrize("lead", [(12,), (3, 4)])
@pytest.mark.parametrize("r", [1.0, 4.0])
def test_pstable_call_and_projections_match_jax(lead, r):
    x, a, b = _pstable_inputs(lead, 64, 32, seed=len(lead))
    fam = hashes.PStableHash(alpha=torch.as_tensor(a),
                             b=torch.as_tensor(b), r=r)
    jfam = jhashes.PStableHash(alpha=jnp.asarray(a), b=jnp.asarray(b), r=r)
    h, proj = fam(torch.as_tensor(x)), fam.projections(torch.as_tensor(x))
    hj, pj = np.asarray(jfam(jnp.asarray(x))), np.asarray(
        jfam.projections(jnp.asarray(x)))
    assert h.dtype == torch.int32 and proj.dtype == torch.float32
    assert tuple(h.shape) == tuple(proj.shape) == tuple(lead) + (32,)
    assert h.shape == hj.shape
    _assert_hashes(h.numpy(), proj.numpy(), hj, pj)


def test_pstable_on_cpu_tensors_takes_the_plain_version():
    dispatch.reset_launches()
    fam = hashes.PStableHash.create(torch.Generator().manual_seed(0), 16, 8)
    fam(torch.randn(4, 16))
    fam.projections(torch.randn(2, 3, 16))
    ops.pstable_hash(torch.randn(3, 16), fam.alpha, fam.b, fam.r)
    assert all(v == 0 for v in dispatch.launches.values())
