"""The port's (quasi-)Monte Carlo embeddings (``repro_torch.core.montecarlo``)
against the JAX package's ``repro.core.montecarlo``, on the CPU.

Tolerances: Sobol and Halton points bit-equal (both are the same numpy
code); float32 ``qmc_nodes`` bit-equal (mapped in float64, cast once, as
``jnp.asarray`` does with x64 off); ``mc_embedding`` bit-equal (one f32
multiply by the same rounded scale).  ``mc_nodes`` cannot equal
``jax.random``'s draws; it is held to its own determinism and range.  The
error properties mirror ``tests/test_montecarlo.py`` with the same bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import montecarlo as jmc  # noqa: E402
from repro_torch.core import functional, montecarlo, wasserstein  # noqa: E402


@pytest.mark.parametrize("d", [1, 2, 5, 10])
@pytest.mark.parametrize("skip", [0, 64, 1000])
def test_sobol_bit_equal_to_jax(d, skip):
    got = montecarlo.sobol(300, d, skip=skip)
    want = jmc.sobol(300, d, skip=skip)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 3, 7, 12])
@pytest.mark.parametrize("skip", [0, 64, 999])
def test_halton_bit_equal_to_jax(d, skip):
    got = montecarlo.halton(257, d, skip=skip)
    want = jmc.halton(257, d, skip=skip)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_sequence_dimension_limits():
    with pytest.raises(ValueError, match="d <= 10"):
        montecarlo.sobol(4, 11)
    with pytest.raises(ValueError, match="d <= 12"):
        montecarlo.halton(4, 13)
    with pytest.raises(ValueError, match="unknown sequence"):
        montecarlo.qmc_nodes(4, sequence="lattice")


def test_sobol_first_points_dim1():
    pts = montecarlo.sobol(8, 1)[:, 0]
    np.testing.assert_allclose(
        pts, [0.0, 0.5, 0.75, 0.25, 0.375, 0.875, 0.625, 0.125], atol=1e-12)


@pytest.mark.parametrize("sequence", ["sobol", "halton"])
@pytest.mark.parametrize("interval", [(0.0, 1.0), (1e-3, 1 - 1e-3),
                                      (-1.0, 2.0)])
@pytest.mark.parametrize("n,d", [(64, 1), (100, 3)])
def test_qmc_nodes_bit_equal_to_jax(sequence, interval, n, d):
    got = montecarlo.qmc_nodes(n, d, interval, sequence, device="cpu")
    want = np.asarray(jmc.qmc_nodes(n, d, interval, sequence))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_qmc_nodes_float32_arithmetic_would_differ():
    """Why the map runs in float64: the same map in float32 moves nodes."""
    u = montecarlo.sobol(4096, 1, skip=64)[:, 0]
    a, b = 1e-3, 1 - 1e-3
    f32 = (np.float32(a) + np.float32(b - a) * u.astype(np.float32))
    nodes = montecarlo.qmc_nodes(4096, 1, (a, b), device="cpu")
    nodes = nodes[:, 0].numpy()
    assert (f32.astype(np.float32) != nodes).any()


@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("volume", [1.0, 2.5, 0.998])
@pytest.mark.parametrize("lead", [(23,), (3, 5)])
def test_mc_embedding_bit_equal_to_jax(p, volume, lead):
    x = np.random.default_rng(len(lead)).normal(
        size=lead + (64,)).astype(np.float32)
    got = montecarlo.mc_embedding(torch.as_tensor(x), volume, p)
    want = np.asarray(jmc.mc_embedding(jnp.asarray(x), volume, p))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_embed_functions_mc_bit_equal_to_jax():
    nodes = montecarlo.qmc_nodes(64, 1, device="cpu")
    jnodes = jmc.qmc_nodes(64, 1)
    got = montecarlo.embed_functions_mc(
        lambda x: torch.stack([torch.sin(3 * x), x * x]), nodes, 1.0, 1.0)
    want = jmc.embed_functions_mc(
        lambda x: jnp.stack([jnp.sin(3 * x), x * x]), jnodes, 1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_mc_nodes_deterministic_on_the_cpu_generator():
    a = montecarlo.mc_nodes(torch.Generator().manual_seed(3), 500, 2,
                            (-1.0, 2.0), device="cpu")
    b = montecarlo.mc_nodes(torch.Generator().manual_seed(3), 500, 2,
                            (-1.0, 2.0), device="cpu")
    assert a.shape == (500, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= -1.0 and float(a.max()) < 2.0
    assert abs(float(a.mean()) - 0.5) < 0.1


def test_mc_embedding_norm_scaling():
    emb = montecarlo.mc_embedding(torch.ones((1, 100)), volume=2.0, p=2.0)
    assert float(torch.linalg.norm(emb)) == pytest.approx(np.sqrt(2.0),
                                                          rel=1e-6)


@pytest.mark.parametrize("seed", range(5))
def test_mc_distance_estimate_sines(seed):
    gen = torch.Generator().manual_seed(seed)
    d = functional.random_sines(gen, 2)
    nodes = montecarlo.mc_nodes(gen, 2048, 1, device="cpu")[:, 0]
    emb = montecarlo.mc_embedding(functional.sine_values(d, nodes), 1.0)
    est = float(torch.linalg.norm(emb[0] - emb[1]))
    true = float(functional.sine_l2_dist(d[0], d[1]))
    assert abs(est - true) < 0.1


def _gauss_err(nodes_fn, mu1, s1, mu2, s2, vol):
    ref_nodes, _ = wasserstein.icdf_nodes_qmc(1 << 14, device="cpu")
    true = torch.linalg.norm(
        wasserstein.w2_embedding_gaussian(mu1, s1, ref_nodes, vol)
        - wasserstein.w2_embedding_gaussian(mu2, s2, ref_nodes, vol), dim=-1)
    nodes = nodes_fn()
    est = torch.linalg.norm(
        wasserstein.w2_embedding_gaussian(mu1, s1, nodes, vol)
        - wasserstein.w2_embedding_gaussian(mu2, s2, nodes, vol), dim=-1)
    return float((est - true).abs().mean())


def test_mc_error_decreases_with_n():
    gen = torch.Generator().manual_seed(0)
    mu1, s1 = functional.random_gaussians(gen, 32)
    mu2, s2 = functional.random_gaussians(gen, 32)
    vol = 1.0 - 2.0 * wasserstein.CLIP

    def err(n, seed):
        return _gauss_err(lambda: wasserstein.icdf_nodes_mc(
            torch.Generator().manual_seed(seed), n, device="cpu")[0],
            mu1, s1, mu2, s2, vol)
    e_small = np.mean([err(64, 10 + i) for i in range(3)])
    e_big = np.mean([err(4096, 20 + i) for i in range(3)])
    assert e_big < e_small


def test_qmc_beats_mc():
    gen = torch.Generator().manual_seed(1)
    mu1, s1 = functional.random_gaussians(gen, 32)
    mu2, s2 = functional.random_gaussians(gen, 32)
    vol = 1.0 - 2.0 * wasserstein.CLIP
    err_q = _gauss_err(
        lambda: wasserstein.icdf_nodes_qmc(256, device="cpu")[0],
        mu1, s1, mu2, s2, vol)
    err_m = _gauss_err(lambda: wasserstein.icdf_nodes_mc(
        torch.Generator().manual_seed(3), 256, device="cpu")[0],
        mu1, s1, mu2, s2, vol)
    assert err_q < err_m
