"""The port's collision theory (``repro_torch.core.collision``) against the
JAX package's ``repro.core.collision``, on the CPU.

Tolerances: the closed forms (Eq. 7, Eq. 8 at p in {1, 2}), Theorem 1's
bounds and the amplification rtol 1e-5 atol 1e-6 (f32 elementary
functions of two libraries); the Monte Carlo estimate for other p within
0.01 of the JAX package's (200,000 draws each, from generators that
cannot agree bit for bit: the estimate's standard error is ~0.001) and of
the closed form at p in {1, 2}.  The properties mirror
``tests/test_collision.py`` with its bounds, over fixed grids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import collision as jc  # noqa: E402
from repro_torch.core import collision  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CS = np.array([0.05, 0.3, 0.7, 1.5, 4.0, 10.0], dtype=np.float32)


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("r", [1.0, 4.0, 8.0])
def test_closed_forms_match_jax(p, r):
    got = collision.pstable_collision_prob(CS, r, p)
    want = np.asarray(jc.pstable_collision_prob(CS, r, p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("p", [0.5, 1.5])
def test_general_p_estimate_matches_jax(p):
    c = np.array([0.3, 1.0, 3.0], dtype=np.float32)
    got = collision.pstable_collision_prob(c, 1.0, p).numpy()
    want = np.asarray(jc.pstable_collision_prob(c, 1.0, p))
    np.testing.assert_allclose(got, want, atol=0.01)
    assert float(collision.pstable_collision_prob(0.7, 1.0, p)) == \
        pytest.approx(float(jc.pstable_collision_prob(0.7, 1.0, p)),
                      abs=0.01)


def test_closed_forms_match_mc_estimator():
    for p in (1.0, 2.0):
        for c in (0.3, 0.7, 1.5, 4.0):
            closed = float(collision.pstable_collision_prob(c, 1.0, p))
            mc = float(collision._pstable_collision_prob_mc(c, 1.0, p))
            assert abs(closed - mc) < 0.01, (p, c)


def test_mc_estimator_is_deterministic():
    a = collision._pstable_collision_prob_mc(np.array([0.5, 2.0]), 1.0, 1.5)
    b = collision._pstable_collision_prob_mc(np.array([0.5, 2.0]), 1.0, 1.5)
    assert torch.equal(a, b) and a.shape == (2,)


def test_simhash_prob_matches_jax():
    s = np.linspace(-1.2, 1.2, 49).astype(np.float32)
    got = collision.simhash_collision_prob(s)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jc.simhash_collision_prob(s)),
                               **TOL)
    assert ((got >= 0) & (got <= 1)).all()
    assert float(collision.simhash_collision_prob(1.0)) == pytest.approx(
        1.0, abs=1e-6)
    assert abs(float(collision.simhash_collision_prob(-1.0))) < 1e-6


@pytest.mark.parametrize("fn", ["theorem1_bounds",
                                "theorem1_bounds_corrected"])
@pytest.mark.parametrize("p", [1.0, 2.0])
def test_theorem1_bounds_match_jax(fn, p):
    c = np.array([0.2, 0.5, 1.0, 2.0, 5.0], dtype=np.float32)
    eps = (c * np.array([0.001, 0.01, 0.05, 0.1, 0.15])).astype(np.float32)
    lo, hi = getattr(collision, fn)(c, 1.0, eps, p)
    jlo, jhi = getattr(jc, fn)(c, 1.0, eps, p)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), **TOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), **TOL)


def test_fp_sup():
    assert collision.fp_sup(2.0) == jc.fp_sup(2.0)
    assert collision.fp_sup(1.0) == jc.fp_sup(1.0)
    with pytest.raises(ValueError):
        collision.fp_sup(1.5)


@pytest.mark.parametrize("c", [0.05, 0.3, 1.0, 3.0, 9.0])
def test_p2_monotone_decreasing_in_c(c):
    p1 = float(collision.pstable_collision_prob(c, 1.0, 2.0))
    p2 = float(collision.pstable_collision_prob(c * 1.1, 1.0, 2.0))
    assert p2 <= p1 + 1e-9
    assert 0.0 <= p1 <= 1.0


@pytest.mark.parametrize("c", [0.2, 1.0, 5.0])
@pytest.mark.parametrize("eps_frac", [0.001, 0.05, 0.1])
def test_theorem1_bounds_order(c, eps_frac):
    eps = eps_frac * c
    P = float(collision.pstable_collision_prob(c, 1.0, 2.0))
    lo, hi = (float(t) for t in collision.theorem1_bounds(c, 1.0, eps, 2.0))
    assert lo <= P + 1e-6 and P <= hi + 1e-6
    lo2, hi2 = collision.theorem1_bounds(c, 1.0, eps / 10, 2.0)
    assert float(hi2) - float(lo2) <= (hi - lo) + 1e-6
    assert (hi - lo) <= 3.0 * eps / c + 1e-6


@pytest.mark.parametrize("c", [0.2, 1.0, 5.0])
@pytest.mark.parametrize("eps_frac", [0.001, 0.05, 0.1])
def test_theorem1_corrected_bounds_contain_perturbed_probability(c,
                                                                 eps_frac):
    eps = eps_frac * c
    lo, hi = collision.theorem1_bounds_corrected(c, 1.0, eps, 2.0)
    for cp in (c - eps, c - eps / 2, c + eps / 2, c + eps):
        p = float(collision.pstable_collision_prob(max(cp, 1e-6), 1.0, 2.0))
        assert float(lo) - 1e-4 <= p <= float(hi) + 1e-4


def test_amplification_matches_jax():
    p1 = np.linspace(0.0, 1.0, 11).astype(np.float32)
    got = collision.expected_collisions_k_l(p1, 4, 8)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jc.expected_collisions_k_l(p1, 4, 8)), **TOL)
    assert float(collision.expected_collisions_k_l(0.7, 4, 8)) == \
        pytest.approx(1 - (1 - 0.7 ** 4) ** 8, abs=1e-6)
