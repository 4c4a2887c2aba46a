"""The port's Chebyshev coefficient functions and Algorithm 1's truncation
(``repro_torch.core.basis``) against the JAX package's, on the CPU.

Tolerances: ``cheb_coeffs`` / ``cheb_l2_coeffs`` / ``embed_functions``
rtol 1e-5 atol 1e-6 (one f32 matmul or FFT each, summed in the two
libraries' orders); ``choose_Nf`` and ``truncate_pad`` exact (comparisons
and selects).  The properties mirror ``tests/test_basis.py`` with its
bounds, over fixed seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import basis as jb  # noqa: E402
from repro_torch.core import basis, functional  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _f(b, n, seed):
    return np.random.default_rng(seed).normal(size=(b, n)).astype(np.float32)


@pytest.mark.parametrize("use_matmul", [True, False])
@pytest.mark.parametrize("n", [16, 33, 96])
def test_cheb_coeffs_match_jax(use_matmul, n):
    f = _f(7, n, n)
    got = basis.cheb_coeffs(torch.as_tensor(f), use_matmul=use_matmul)
    want = np.asarray(jb.cheb_coeffs(jnp.asarray(f), use_matmul=use_matmul))
    assert got.dtype == torch.float32 and got.shape == (7, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("measure", ["lebesgue", "theta"])
@pytest.mark.parametrize("interval", [(-1.0, 1.0), (0.0, 2.0),
                                      (1e-3, 1 - 1e-3)])
@pytest.mark.parametrize("use_matmul", [True, False])
def test_cheb_l2_coeffs_match_jax(measure, interval, use_matmul):
    f = _f(5, 64, 1)
    got = basis.cheb_l2_coeffs(torch.as_tensor(f), interval, use_matmul,
                               measure)
    want = np.asarray(jb.cheb_l2_coeffs(jnp.asarray(f), interval, use_matmul,
                                        measure))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cheb_l2_coeffs_rejects_unknown_measure():
    with pytest.raises(ValueError, match="measure"):
        basis.cheb_l2_coeffs(torch.zeros((1, 8)), measure="dx")


def test_dct_matmul_matches_fft_dct():
    f = torch.as_tensor(_f(8, 96, 2))
    np.testing.assert_allclose(
        basis.cheb_coeffs(f, use_matmul=True).numpy(),
        basis.cheb_coeffs(f, use_matmul=False).numpy(), atol=2e-4, rtol=2e-4)


def test_choose_nf_matches_jax():
    c = np.array([[1.0, 0.5, 0.1, 1e-9, 1e-10, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [1e-9, 1.0, 1e-9, 1e-9, 1e-3, 1e-9]], dtype=np.float32)
    got = basis.choose_Nf(torch.as_tensor(c), tol=1e-6)
    want = np.asarray(jb.choose_Nf(jnp.asarray(c), tol=1e-6))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [3, 1, 5]


@pytest.mark.parametrize("n_f", [0, 6, 10, [3, 0, 10, 7]])
@pytest.mark.parametrize("n_total", [4, 10, 16])
def test_truncate_pad_matches_jax(n_f, n_total):
    c = _f(4, 10, 3)
    nf_t = torch.as_tensor(n_f) if isinstance(n_f, list) else n_f
    nf_j = jnp.asarray(n_f) if isinstance(n_f, list) else n_f
    got = basis.truncate_pad(torch.as_tensor(c), nf_t, n_total)
    want = np.asarray(jb.truncate_pad(jnp.asarray(c), nf_j, n_total))
    assert got.shape == (4, n_total)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["chebyshev", "legendre"])
def test_embed_functions_matches_jax(which):
    got = basis.embed_functions(
        lambda x: torch.stack([torch.exp(x) * torch.sin(3 * x), x * x]), 32,
        (0.0, 1.0), which)
    want = jb.embed_functions(
        lambda x: jnp.stack([jnp.exp(x) * jnp.sin(3 * x), x * x]), 32,
        (0.0, 1.0), which)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="basis"):
        basis.embed_functions(lambda x: x[None], 8, basis="fourier")


@pytest.mark.parametrize("seed", range(5))
def test_cheb_lebesgue_isometry_sines(seed):
    d = functional.random_sines(torch.Generator().manual_seed(seed), 2)
    nodes = basis.cheb_nodes(96, (0.0, 1.0))
    g = basis.cheb_l2_coeffs(functional.sine_values(d, nodes), (0.0, 1.0))
    emb = float(torch.linalg.norm(g[0] - g[1]))
    true = float(functional.sine_l2_dist(d[0], d[1]))
    assert abs(emb - true) < 5e-3 + 0.02 * true


def test_cheb_theta_isometry_exact_for_cosine_series():
    n = 64
    theta = torch.pi * (torch.arange(n, dtype=torch.float32) + 0.5) / n
    g = 0.3 + 0.5 * torch.cos(theta) - 0.2 * torch.cos(3 * theta)
    gamma = basis.cheb_l2_coeffs(g[None, :], (-1.0, 1.0), measure="theta")
    true = float(np.sqrt(np.pi * 0.3 ** 2 + np.pi / 2 * (0.5 ** 2 + 0.2 ** 2)))
    assert abs(float(torch.linalg.norm(gamma)) - true) < 1e-5


def test_parseval_norm():
    nodes = basis.cheb_nodes(128, (0.0, 1.0))
    g = basis.cheb_l2_coeffs((torch.exp(nodes) * torch.sin(3 * nodes))[None],
                             (0.0, 1.0))
    xs = np.linspace(0, 1, 40001)
    ref = np.sqrt(np.trapezoid((np.exp(xs) * np.sin(3 * xs)) ** 2, xs))
    assert abs(float(torch.linalg.norm(g)) - ref) < 2e-3 * ref + 1e-4
