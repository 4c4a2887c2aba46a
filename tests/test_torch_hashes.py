"""The port's hash families (``repro_torch.core.hashes``) and hashing ops
against the JAX package's, on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
packages (the JAX ``alpha`` reaches the port through ``convert.py``).
Tolerances: signature bits equal wherever |x @ alpha| >= 1e-5 (a sum
within 1e-5 of 0 may take either sign in another summation order; those
cases are counted), Hamming distances exact, p-stable projections rtol
1e-6 atol 1e-5 and hashes equal away from a floor boundary
(|proj - round(proj)| > 1e-4, counted), as the ROADMAP's parity contract.
With a heavy-tailed alpha (p = 1, Chambers-Mallows-Stuck p) the boundary
is relative, |proj - round(proj)| <= 1e-4 + 1e-6 |proj|, and projections
are held within 1e-6 of their terms' size.  The saturating conversion is
exact.  The CMS formula rtol 1e-4 against float64 numpy on fixed (theta,
w); its draws, which cannot equal ``jax.random``'s, by a two-sample KS
test (p-value > 1e-3) and the stability property.  ``LazyCoeffs`` carried
across bit-equal; ``LazyPStableHash`` and ``ALSH`` as the families they
hash with, their transforms rtol 1e-5 atol 1e-6.
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
from repro_torch.core import hashes, montecarlo, wasserstein  # noqa: E402
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


# -- the saturating conversion (the plain K1 epilogue) -----------------------


def test_plain_hash_saturates_as_jax():
    """Projections of +-3e9, +-inf and NaN hash to INT32_MAX, INT32_MIN,
    INT32_MAX, INT32_MIN and 0 through ``ops.pstable_hash_proj`` on the
    CPU, as the JAX package's ``ops`` gives on the same inputs (and as the
    card's conversion does)."""
    x = np.array([[3e9], [-3e9], [np.inf], [-np.inf], [np.nan],
                  [2147483520.0], [-2147483648.0], [-2147483904.0],
                  [1.5], [-0.5]], dtype=np.float32)
    a, b = np.ones((1, 1), np.float32), np.zeros((1,), np.float32)
    h, proj = ops.pstable_hash_proj(*(torch.as_tensor(t) for t in (x, a, b)),
                                    1.0)
    hj, pj = jops.pstable_hash_proj(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b), 1.0, use_kernel=False)
    imax, imin = 2 ** 31 - 1, -2 ** 31
    want = [imax, imin, imax, imin, 0, 2147483520, imin, imin, 1, -1]
    assert h[:, 0].tolist() == want
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(proj.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ref.floor_to_int32(torch.as_tensor(
        x[:, 0])).numpy(), want)


# -- p = 1 and general p: heavy-tailed alpha ---------------------------------


def _near_rel(proj):
    """A relative floor boundary: |proj - round(proj)| <= 1e-4 + 1e-6
    |proj| (an f32 ulp of a Cauchy or CMS projection passes 1e-4)."""
    return np.abs(proj - np.round(proj)) <= BOUNDARY + 1e-6 * np.abs(proj)


def _pstable_alpha(p, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return hashes.sample_pstable(gen, shape, p).numpy()


@pytest.mark.parametrize("p", [1.0, 0.5, 1.5])
@pytest.mark.parametrize("r", [1.0, 8.0])
def test_pstable_hash_general_p_matches_jax(p, r):
    """K1's plain version against the JAX package's at p = 1 (Cauchy) and
    CMS p: zero mismatches away from a relative boundary; the boundary
    cases are counted (at most all of them may flip).  At these seeds, of
    8,192 hashes: p = 1 and 1.5, 1-9 boundary cases and none flips; p =
    0.5, 959-1,557, of which 84-345 flip (past |proj| ~ 5e5 an f32 ulp
    passes the margin, so every such projection is a boundary case)."""
    rng = np.random.default_rng(int(p * 10 + r))
    x = rng.normal(size=(256, 64)).astype(np.float32) * 0.5
    a = _pstable_alpha(p, (64, 32), seed=int(p * 10))
    b = rng.uniform(size=(32,)).astype(np.float32)
    h, proj = ops.pstable_hash_proj(*(torch.as_tensor(t) for t in (x, a, b)),
                                    r)
    hj, pj = jops.pstable_hash_proj(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b), r, use_kernel=False)
    pj = np.asarray(pj)
    # projections within 1e-6 of the size of their terms, sum |x_i a_i| / r
    # (relative to the sum itself, cancellation among heavy-tailed terms
    # would hold it to more than f32 gives)
    terms = np.abs(x).astype(np.float64) @ np.abs(a).astype(np.float64) / r
    assert (np.abs(proj.numpy().astype(np.float64) - pj)
            <= 1e-6 * terms + 1e-6).all()
    near = _near_rel(pj)
    mism = h.numpy() != np.asarray(hj)
    assert not mism[~near].any()
    assert int(mism.sum()) <= int(near.sum())
    if p < 1.0:
        assert np.abs(pj).max() > 1e3        # the tails this is about


# -- Chambers-Mallows-Stuck --------------------------------------------------


@pytest.mark.parametrize("p", [0.3, 0.5, 1.0, 1.5, 1.9])
def test_cms_formula_matches_numpy(p):
    """``_cms`` on fixed (theta, w) against the same expression in float64
    numpy, rtol 1e-4 (f32 powers of a ratio near 0 or 1)."""
    rng = np.random.default_rng(int(p * 10))
    theta = rng.uniform(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, 4000)
    w = rng.exponential(size=4000)
    t32, w32 = theta.astype(np.float32), w.astype(np.float32)
    got = hashes._cms(torch.as_tensor(t32), torch.as_tensor(w32), p).numpy()
    t64, w64 = t32.astype(np.float64), w32.astype(np.float64)
    want = (np.sin(p * t64) / np.cos(t64) ** (1.0 / p)
            * (np.cos(t64 * (1.0 - p)) / w64) ** ((1.0 - p) / p))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if p == 1.0:
        np.testing.assert_allclose(got, np.tan(t64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [0.5, 1.5])
def test_cms_draws_distributed_as_jax(p):
    """Two-sample Kolmogorov-Smirnov test of 20,000 port draws against
    20,000 JAX draws: p-value > 1e-3."""
    stats = pytest.importorskip("scipy.stats")
    got = hashes.sample_pstable(torch.Generator().manual_seed(0), (20000,),
                                p).numpy()
    want = np.asarray(jhashes.sample_pstable(jax.random.PRNGKey(0),
                                             (20000,), p))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert stats.ks_2samp(got, want).pvalue > 1e-3


def test_pstable_general_p_stability():
    """(X1 + X2) / 2^(1/p) is distributed as X1 (``tests/test_hashes.py``'s
    check, same quantiles and bound)."""
    p = 1.5
    x1 = hashes.sample_pstable(torch.Generator().manual_seed(1), (30000,), p)
    x2 = hashes.sample_pstable(torch.Generator().manual_seed(2), (30000,), p)
    combo = (x1 + x2) / (2.0 ** (1.0 / p))
    qs = [10, 25, 50, 75, 90]
    np.testing.assert_allclose(np.percentile(x1.numpy(), qs),
                               np.percentile(combo.numpy(), qs), atol=0.12)


def test_pstable_p1_is_cauchy_and_p2_normal():
    x = hashes.sample_pstable(torch.Generator().manual_seed(0), (20000,), 1.0)
    q1, q3 = np.percentile(x.numpy(), [25, 75])
    assert abs(q1 + 1.0) < 0.1 and abs(q3 - 1.0) < 0.1
    y = hashes.sample_pstable(torch.Generator().manual_seed(0), (20000,), 2.0)
    assert abs(float(y.mean())) < 0.03 and abs(float(y.std()) - 1.0) < 0.03


@pytest.mark.parametrize("p", [0.0, -1.0, 2.5])
def test_pstable_rejects_p_outside_the_range(p):
    with pytest.raises(ValueError, match="p must be"):
        hashes.sample_pstable(torch.Generator(), (4,), p)


# -- Algorithm 1's lazy coefficients ----------------------------------------


def test_lazy_coeffs_growth_invariance():
    """alpha[j] does not depend on the path of growth."""
    a = hashes.LazyCoeffs(5, 8, p=1.5, device="cpu")
    b = hashes.LazyCoeffs(5, 8, p=1.5, device="cpu")
    a.ensure(1000)
    for n in (10, 130, 600, 1000):
        b.ensure(n)
    assert a.current_n == b.current_n == 1024
    assert torch.equal(a.alpha(1000), b.alpha(1000))
    assert torch.equal(a.alpha(37), b.alpha(1000)[:37])
    c = hashes.LazyCoeffs(6, 8, p=1.5, device="cpu")
    assert not torch.equal(a.alpha(128), c.alpha(128))


def test_lazy_coeffs_carried_blocks_match_jax():
    """The JAX package's blocks carried across give its alpha bit for bit;
    rows past them are the port's own (seeded) draws."""
    jl = jhashes.LazyCoeffs(jax.random.PRNGKey(3), 8, p=1.0)
    jl.ensure(300)
    coeffs = convert.lazy_coeffs_from_numpy(jl._blocks, seed=3, p=1.0,
                                            device="cpu")
    np.testing.assert_array_equal(coeffs.alpha(300).numpy(),
                                  np.asarray(jl.alpha(300)))
    assert coeffs.current_n == 384
    grown = coeffs.alpha(500)
    np.testing.assert_array_equal(grown[:384].numpy(),
                                  np.asarray(jl.alpha(384)))
    own = hashes.LazyCoeffs(3, 8, p=1.0, device="cpu")
    assert torch.equal(grown[384:], own.alpha(500)[384:])


@pytest.mark.parametrize("n_f", [40, 128, 300])
def test_lazy_hash_matches_jax(n_f):
    """``LazyPStableHash`` with the JAX hasher's blocks and b: hashes equal
    away from a floor boundary, for one vector and a batch."""
    key = jax.random.PRNGKey(n_f)
    jlz = jhashes.LazyPStableHash.create(key, 32, r=1.0)
    jlz.coeffs.ensure(n_f)
    lz = convert.lazy_hash_from_numpy(jlz.coeffs._blocks, np.asarray(jlz.b),
                                      1.0, device="cpu")
    g = np.random.default_rng(n_f).normal(size=(6, n_f)).astype(np.float32)
    h = lz(torch.as_tensor(g)).numpy()
    hj = np.asarray(jlz(jnp.asarray(g)))
    proj = g.astype(np.float64) @ np.asarray(jlz.coeffs.alpha(n_f),
                                             np.float64) + np.asarray(jlz.b)
    near = _near_rel(proj)
    assert h.shape == hj.shape == (6, 32) and h.dtype == np.int32
    assert not (h != hj)[~near].any()
    np.testing.assert_array_equal(lz(torch.as_tensor(g[0])).numpy(), h[0])


def test_lazy_hash_nf_sparsity():
    """Remark 2: the hash of gamma equals the hash of gamma zero-padded."""
    lz = hashes.LazyPStableHash.create(0, 32, device="cpu")
    g = torch.randn(40, generator=torch.Generator().manual_seed(1))
    assert torch.equal(lz(g), lz(torch.cat([g, torch.zeros(200)])))
    assert lz.coeffs.current_n == 256
    again = hashes.LazyPStableHash.create(0, 32, device="cpu")
    assert torch.equal(again.b, lz.b)


@pytest.mark.parametrize("make", [
    lambda: hashes.LazyCoeffs(0, 8),
    lambda: hashes.LazyPStableHash.create(0, 8),
    lambda: montecarlo.mc_nodes(torch.Generator().manual_seed(0), 8),
    lambda: montecarlo.qmc_nodes(8),
    lambda: wasserstein.icdf_nodes_mc(torch.Generator().manual_seed(0), 8),
    lambda: wasserstein.icdf_nodes_qmc(8),
], ids=["LazyCoeffs", "LazyPStableHash", "mc_nodes", "qmc_nodes",
        "icdf_nodes_mc", "icdf_nodes_qmc"])
def test_lazy_families_and_nodes_default_to_the_card(monkeypatch, make):
    """With no device named these land on the card, and so raise where
    there is none, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


# -- ALSH --------------------------------------------------------------------


def _alsh_pair(variant, seed=0):
    key = jax.random.PRNGKey(seed)
    jal = jhashes.ALSH.create(key, 64, 1024 if variant == "sign" else 32,
                              variant=variant, r=1.0)
    if variant == "sign":
        tal = convert.alsh_from_numpy(jal.m, jal.scale_u, variant,
                                      np.asarray(jal.inner.alpha),
                                      device="cpu")
    else:
        tal = convert.alsh_from_numpy(jal.m, jal.scale_u, variant,
                                      np.asarray(jal.inner.alpha),
                                      np.asarray(jal.inner.b), jal.inner.r,
                                      device="cpu")
    return jal, tal


@pytest.mark.parametrize("variant", ["sign", "l2"])
def test_alsh_matches_jax(variant):
    """The transforms rtol 1e-5 atol 1e-6; hashes equal away from a sign
    (|P(x) @ alpha| < 1e-5) or a floor boundary, database and queries, at
    width N + m = 67."""
    jal, tal = _alsh_pair(variant)
    x = np.random.default_rng(0).normal(size=(200, 64)).astype(np.float32)
    for jt, tt, jh, th in (
            (jal.preprocess, tal.preprocess, jal.hash_db, tal.hash_db),
            (jal.query_transform, tal.query_transform, jal.hash_query,
             tal.hash_query)):
        px = tt(torch.as_tensor(x))
        assert px.shape == (200, 67)
        np.testing.assert_allclose(px.numpy(), np.asarray(jt(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
        got, want = th(torch.as_tensor(x)).numpy(), np.asarray(
            jh(jnp.asarray(x)))
        proj = px.numpy().astype(np.float64) @ np.asarray(
            jal.inner.alpha, np.float64)
        if variant == "sign":
            near = np.abs(proj) < NEAR
            assert not (_unpack(got) != _unpack(want))[~near].any()
        else:
            near = _near_rel(proj / jal.inner.r + np.asarray(jal.inner.b))
            assert not (got != want)[~near].any()


def test_alsh_max_norm_and_variants():
    jal, tal = _alsh_pair("sign")
    x = np.random.default_rng(1).normal(size=(10, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tal.preprocess(torch.as_tensor(x), max_norm=20.0).numpy(),
        np.asarray(jal.preprocess(jnp.asarray(x), max_norm=20.0)),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        hashes.ALSH.create(torch.Generator(), 8, 32, variant="cosine")
    al = hashes.ALSH.create(torch.Generator().manual_seed(0), 8, 32,
                            variant="l2")
    assert isinstance(al.inner, hashes.PStableHash)
    assert al.inner.alpha.shape == (11, 32)


@pytest.mark.parametrize("seed", range(3))
def test_alsh_mips_ranking(seed):
    """ALSH signatures rank the max-inner-product item in the best decile
    of 256 by Hamming distance (``tests/test_hashes.py``'s bound)."""
    gen = torch.Generator().manual_seed(seed)
    db = torch.randn((256, 32), generator=gen)
    q = torch.randn((32,), generator=gen)
    best = int(torch.argmax(db @ q))
    al = hashes.ALSH.create(gen, 32, 1024, variant="sign")
    ham = hashes.SimHash.hamming(al.hash_db(db), al.hash_query(q[None]))
    assert int((ham < ham[best]).sum()) < 26
