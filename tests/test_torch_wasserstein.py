"""The port's 1-D Wasserstein module (``repro_torch.core.wasserstein``) and
functional datasets against the JAX package's, on the CPU.

Tolerances: ``empirical_icdf`` and ``w2_embedding_samples`` bit-equal (a
sort, ``floor(u * m)`` from the same f32 ``u``, a gather, one multiply) at
m in {256, 100, 7}; the QMC and Chebyshev node sets bit-equal;
``gaussian_w2`` and ``wasserstein_1d_exact`` rtol 1e-6; ``ndtri`` rtol
1e-6; ``gaussian_icdf`` = mu + sigma ndtri(u) and the Gaussian MC
embedding within 1e-6 of the terms' size, |mu| + |sigma ndtri(u)| (times
the embedding's scale): where mu and sigma ndtri(u) nearly cancel, a
bound relative to the sum would hold the sum to more than its terms'
precision; the Chebyshev route (DCT matmul) rtol 1e-5 atol 1e-6;
``w2_embedding_logits`` equal except where a cumulative probability lies
within 1e-6 of a node (the count ``cdf < u`` may flip there; counted:
none of the 512 values at this input).  The properties mirror
``tests/test_wasserstein.py`` with its bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import wasserstein as jw  # noqa: E402
from repro_torch.core import functional, wasserstein  # noqa: E402

T = torch.as_tensor
J = jnp.asarray


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(0.1, 1, n).astype(np.float32))


def test_gaussian_w2_matches_jax():
    mu1, s1 = _gaussians(50, 0)
    mu2, s2 = _gaussians(50, 1)
    got = wasserstein.gaussian_w2(T(mu1), T(s1), T(mu2), T(s2))
    want = np.asarray(jw.gaussian_w2(J(mu1), J(s1), J(mu2), J(s2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert float(wasserstein.gaussian_w2(0.0, 1.0, 0.0, 1.0)) == 0.0
    assert float(wasserstein.gaussian_w2(0.0, 1.0, 3.0, 1.0)) == \
        pytest.approx(3.0, abs=1e-6)
    assert float(wasserstein.gaussian_w2(0.0, 1.0, 0.0, 2.0)) == \
        pytest.approx(1.0, abs=1e-6)


def _within_terms(got, want, u, mu, s, scale=1.0):
    """|got - want| <= 1e-6 scale (|mu| + |s ndtri(u)|), elementwise."""
    z = np.abs(torch.special.ndtri(T(u)).double().numpy())
    terms = scale * (np.abs(mu)[:, None] + np.abs(s)[:, None] * z[None, :])
    assert (np.abs(got.astype(np.float64) - want) <= 1e-6 * terms).all()


def test_ndtri_matches_jax():
    u = np.linspace(1e-3, 1 - 1e-3, 100001).astype(np.float32)
    got = torch.special.ndtri(T(u)).numpy()
    want = np.asarray(jax.scipy.special.ndtri(J(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_gaussian_icdf_matches_jax():
    u = np.linspace(1e-3, 1 - 1e-3, 257).astype(np.float32)
    mu, s = _gaussians(7, 2)
    got = wasserstein.gaussian_icdf(T(u), T(mu)[:, None], T(s)[:, None])
    want = np.asarray(jw.gaussian_icdf(J(u), J(mu)[:, None], J(s)[:, None]))
    assert got.dtype == torch.float32 and got.shape == (7, 257)
    _within_terms(got.numpy(), want, u, mu, s)


@pytest.mark.parametrize("m", [256, 100, 7])
@pytest.mark.parametrize("n_nodes", [64, 33])
def test_empirical_icdf_bit_equal_to_jax(m, n_nodes):
    s = np.random.default_rng(m).normal(size=(9, m)).astype(np.float32)
    u, _ = wasserstein.icdf_nodes_qmc(n_nodes, device="cpu")
    ju, _ = jw.icdf_nodes_qmc(n_nodes)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    got = wasserstein.empirical_icdf(T(s), u)
    want = np.asarray(jw.empirical_icdf(J(s), ju))
    np.testing.assert_array_equal(got.numpy(), want)
    # a grid that hits floor(u m) = m and u m exact
    grid = np.array([0.0, 0.5, 1.0 / m, 1.0 - 1e-7, 0.999999],
                    dtype=np.float32)
    np.testing.assert_array_equal(
        wasserstein.empirical_icdf(T(s), T(grid)).numpy(),
        np.asarray(jw.empirical_icdf(J(s), J(grid))))


def test_empirical_icdf_step():
    out = wasserstein.empirical_icdf(torch.tensor([3.0, 1.0, 2.0]),
                                     torch.tensor([0.1, 0.4, 0.9]))
    np.testing.assert_allclose(out.numpy(), [1.0, 2.0, 3.0])


@pytest.mark.parametrize("m", [256, 100, 7])
@pytest.mark.parametrize("p", [1.0, 2.0])
def test_w2_embedding_samples_bit_equal_to_jax(m, p):
    s = np.random.default_rng(m + 1).normal(size=(4, 5, m)).astype(
        np.float32)
    u, vol = wasserstein.icdf_nodes_qmc(64, device="cpu")
    ju, jvol = jw.icdf_nodes_qmc(64)
    assert vol == jvol
    got = wasserstein.w2_embedding_samples(T(s), u, vol)
    want = np.asarray(jw.w2_embedding_samples(J(s), ju, jvol))
    np.testing.assert_array_equal(got.numpy(), want)
    # the MC embedding at another p, bit-equal as well
    vals = wasserstein.empirical_icdf(T(s), u)
    np.testing.assert_array_equal(
        wasserstein.embed_icdf_mc(vals, vol, p).numpy(),
        np.asarray(jw.embed_icdf_mc(jw.empirical_icdf(J(s), ju), jvol, p)))


def test_w2_embedding_samples_cheb_matches_jax():
    s = np.random.default_rng(5).normal(size=(6, 200)).astype(np.float32)
    u = wasserstein.icdf_nodes_cheb(64)
    ju = jw.icdf_nodes_cheb(64)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-7)
    got = wasserstein.w2_embedding_samples(T(s), T(np.array(ju)), None,
                                           "cheb")
    want = np.asarray(jw.w2_embedding_samples(J(s), ju, None, "cheb"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        wasserstein.w2_embedding_samples(T(s), u, None, "fft")


@pytest.mark.parametrize("method", ["mc", "cheb"])
def test_w2_embedding_gaussian_matches_jax(method):
    mu, s = _gaussians(11, 3)
    if method == "mc":
        u, vol = wasserstein.icdf_nodes_qmc(128, device="cpu")
        ju, _ = jw.icdf_nodes_qmc(128)
    else:
        ju, vol = jw.icdf_nodes_cheb(128), None
        u = T(np.array(ju))
    got = wasserstein.w2_embedding_gaussian(T(mu), T(s), u, vol, method)
    want = np.asarray(jw.w2_embedding_gaussian(J(mu), J(s), ju, vol,
                                               method))
    assert got.shape == (11, 128)
    if method == "mc":
        _within_terms(got.numpy(), want, u.numpy(), mu, s,
                      scale=(vol / 128) ** 0.5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_icdf_nodes_mc_on_the_clipped_interval():
    u, vol = wasserstein.icdf_nodes_mc(torch.Generator().manual_seed(0), 999,
                                     device="cpu")
    assert vol == pytest.approx(1.0 - 2 * wasserstein.CLIP)
    assert u.shape == (999,) and u.dtype == torch.float32
    assert float(u.min()) >= wasserstein.CLIP
    assert float(u.max()) <= 1.0 - wasserstein.CLIP


@pytest.mark.parametrize("seed", range(4))
def test_wasserstein_1d_exact_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sf = rng.normal(size=300 + seed).astype(np.float32)
    sg = (rng.normal(size=77 * (seed + 1)) * 2 + 0.3).astype(np.float32)
    for p in (1.0, 2.0):
        got = float(wasserstein.wasserstein_1d_exact(T(sf), T(sg), p))
        want = float(jw.wasserstein_1d_exact(J(sf), J(sg), p))
        assert got == pytest.approx(want, rel=1e-6)


def test_empirical_exact_handles_unequal_sample_counts():
    d = float(wasserstein.wasserstein_1d_exact(torch.tensor([0.0, 1.0]),
                                               torch.tensor([0.0, 1.0, 2.0]),
                                               1.0))
    assert abs(d - 0.5) < 1e-6


@pytest.mark.parametrize("seed", range(5))
def test_embedding_distance_matches_closed_form(seed):
    mu, s = functional.random_gaussians(torch.Generator().manual_seed(seed),
                                        2)
    nodes, vol = wasserstein.icdf_nodes_qmc(2048, device="cpu")
    emb = wasserstein.w2_embedding_gaussian(mu, s, nodes, vol, "mc")
    est = float(torch.linalg.norm(emb[0] - emb[1]))
    true = float(wasserstein.gaussian_w2(mu[0], s[0], mu[1], s[1]))
    assert abs(est - true) < 0.03 + 0.05 * true


@pytest.mark.parametrize("seed", range(5))
def test_empirical_exact_w2_vs_closed_form(seed):
    gen = torch.Generator().manual_seed(seed)
    mu, s = functional.random_gaussians(gen, 2)
    sf = mu[0] + s[0] * torch.randn(8000, generator=gen)
    sg = mu[1] + s[1] * torch.randn(6000, generator=gen)
    est = float(wasserstein.wasserstein_1d_exact(sf, sg, 2.0))
    true = float(wasserstein.gaussian_w2(mu[0], s[0], mu[1], s[1]))
    assert abs(est - true) < 0.08 + 0.1 * true


def _logits():
    support = np.linspace(-1, 1, 101).astype(np.float32)
    rng = np.random.default_rng(0)
    lg = [-((support - c) ** 2) * 20 for c in (0.0, 0.1, 0.8)]
    lg += list(rng.normal(size=(5, 101)) * 3)
    return np.stack(lg).astype(np.float32), support


def test_w2_embedding_logits_matches_jax():
    lg, support = _logits()
    u, vol = wasserstein.icdf_nodes_qmc(64, device="cpu")
    ju, _ = jw.icdf_nodes_qmc(64)
    got = wasserstein.w2_embedding_logits(T(lg), T(support), u, vol).numpy()
    want = np.asarray(jw.w2_embedding_logits(J(lg), J(support), ju, vol))
    cdf = np.cumsum(np.exp(lg.astype(np.float64)) / np.exp(
        lg.astype(np.float64)).sum(-1, keepdims=True), axis=-1)
    near = (np.abs(cdf[:, None, :] - u.numpy()[None, :, None]) < 1e-6).any(
        axis=-1)
    assert not (got != want)[~near].any()
    assert int((got != want).sum()) <= int(near.sum())


def test_w2_embedding_logits_orders_distributions():
    lg, support = _logits()
    nodes, vol = wasserstein.icdf_nodes_qmc(64, device="cpu")
    embs = wasserstein.w2_embedding_logits(T(lg[:3]), T(support), nodes, vol)
    d_near = float(torch.linalg.norm(embs[0] - embs[1]))
    d_far = float(torch.linalg.norm(embs[0] - embs[2]))
    assert d_near < d_far
    assert abs(d_near - 0.1) < 0.05
    assert abs(d_far - 0.8) < 0.1


# -- functional datasets -----------------------------------------------------


def test_sine_closed_forms_match_jax():
    from repro.core import functional as jf
    d1 = np.random.default_rng(0).uniform(0, 2 * np.pi, 20).astype(
        np.float32)
    d2 = np.random.default_rng(1).uniform(0, 2 * np.pi, 20).astype(
        np.float32)
    x = np.linspace(0, 1, 33).astype(np.float32)
    for name in ("sine_cossim", "sine_inner", "sine_l2_dist"):
        np.testing.assert_allclose(
            getattr(functional, name)(T(d1), T(d2)).numpy(),
            np.asarray(getattr(jf, name)(J(d1), J(d2))), rtol=1e-5,
            atol=1e-6)
    np.testing.assert_allclose(
        functional.sine_values(T(d1), T(x)).numpy(),
        np.asarray(jf.sine_values(J(d1), J(x))), rtol=1e-5, atol=1e-6)


def test_random_draws_lie_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    d = functional.random_sines(gen, 1000)
    assert float(d.min()) >= 0.0 and float(d.max()) < 2 * np.pi
    mu, sig = functional.random_gaussians(gen, 1000)
    assert float(mu.min()) >= -1.0 and float(mu.max()) < 1.0
    assert float(sig.min()) >= 0.0 and float(sig.max()) < 1.0
    assert abs(float((sig ** 2).mean()) - 0.5) < 0.05    # var ~ U[0, 1]
    mu2, sig2 = functional.random_gaussians(gen, 500, (0.0, 2.0), (0.5, 1.0))
    assert float(mu2.min()) >= 0.0 and float(sig2.min()) >= 0.5
