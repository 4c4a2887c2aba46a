"""The port's QMC and Wasserstein embedders (``repro_torch.embedders``)
against the JAX package's, on the CPU.

Tolerances: both embedders bit-equal to the JAX package's on the same
input, node sets included (a scale multiply; a sort, a gather and a scale
multiply), and bit-equal across batch shapes (``embed_batched``'s padding
is invisible: rows are independent); ``embed_gaussian`` through ``ndtri``
within 1e-6 of its terms' size (|mu| + |sigma ndtri(u)|, times the
embedding's scale), as ``tests/test_torch_wasserstein.py`` explains.  The
``"mc"`` node set cannot equal ``jax.random``'s; the JAX package's is
carried across (``convert.qmc_nodes_from_numpy``) and then the embed is
bit-equal.  The geometry checks mirror ``tests/test_embedders.py`` with
its bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import wasserstein as jw  # noqa: E402
from repro.embedders import make_embedder as j_make  # noqa: E402
from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.embedders import (QMCEmbedder,  # noqa: E402
                                   WassersteinEmbedder, embedder_names,
                                   make_embedder)
from repro_torch.serve import ServableRegistry, ServableSpec  # noqa: E402

N = 32


def _fvals(b=23, n=N, seed=0):
    return np.random.default_rng(seed).normal(size=(b, n)).astype(np.float32)


def _make(name, n=N, **kw):
    return make_embedder(name, n, device="cpu", **kw)


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("sequence", ["sobol", "halton"])
@pytest.mark.parametrize("volume", [1.0, 2.5])
def test_qmc_embedder_bit_equal_to_jax(p, sequence, volume):
    params = {"sequence": sequence}
    je = j_make("qmc", N, p=p, volume=volume, params=params)
    te = _make("qmc", p=p, volume=volume, params=params)
    fv = _fvals(seed=1)
    np.testing.assert_array_equal(te.embed(fv).numpy(),
                                  np.asarray(je.embed(fv)))
    np.testing.assert_array_equal(te.nodes(), je.nodes())
    assert te.nodes().dtype == np.float32


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_qmc_mc_nodes_carried_across(p):
    je = j_make("qmc", N, p=p, params={"sequence": "mc", "seed": 3})
    te = _make("qmc", p=p, params={"sequence": "mc", "seed": 3})
    own = te.nodes().copy()
    assert own.min() >= 0.0 and own.max() < 1.0
    assert not np.array_equal(own, je.nodes())     # other generators
    # the port's own draw is a pure function of the seed
    np.testing.assert_array_equal(
        _make("qmc", p=p, params={"sequence": "mc", "seed": 3}).nodes(), own)
    assert convert.qmc_nodes_from_numpy(te, np.asarray(je.nodes())) is te
    np.testing.assert_array_equal(te.nodes(), je.nodes())
    fv = _fvals(seed=2)
    np.testing.assert_array_equal(te.embed(fv).numpy(),
                                  np.asarray(je.embed(fv)))
    with pytest.raises(ValueError, match="nodes"):
        convert.qmc_nodes_from_numpy(te, np.zeros(N + 1))


def test_qmc_rejects_unknown_sequence():
    with pytest.raises(ValueError, match="unknown sequence"):
        _make("qmc", params={"sequence": "lattice"})


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("m", [256, 100, 7])
@pytest.mark.parametrize("sequence", ["sobol", "halton"])
def test_wasserstein_embedder_bit_equal_to_jax(p, m, sequence):
    params = {"sequence": sequence}
    je = j_make("wasserstein", 64, p=p, params=params)
    te = _make("wasserstein", 64, p=p, params=params)
    x = (0.3 + 0.7 * np.random.default_rng(m).normal(size=(19, m))).astype(
        np.float32)
    np.testing.assert_array_equal(te.embed(x).numpy(),
                                  np.asarray(je.embed(x)))
    np.testing.assert_array_equal(te.nodes(), je.nodes())
    assert te.volume == je.volume and te.interval == je.interval


def test_wasserstein_embed_gaussian_matches_jax():
    je = j_make("wasserstein", 64)
    te = _make("wasserstein", 64)
    rng = np.random.default_rng(4)
    mu = rng.uniform(-1, 1, 30).astype(np.float32)
    sig = rng.uniform(0.1, 1, 30).astype(np.float32)
    got = te.embed_gaussian(mu, sig).numpy()
    want = np.asarray(je.embed_gaussian(mu, sig))
    z = np.abs(torch.special.ndtri(torch.as_tensor(te.nodes())).double()
               .numpy())
    terms = (te.volume / 64) ** 0.5 * (np.abs(mu)[:, None]
                                       + sig[:, None] * z[None, :])
    assert got.shape == (30, 64)
    assert (np.abs(got.astype(np.float64) - want) <= 1e-6 * terms).all()


@pytest.mark.parametrize("name,width", [("qmc", N), ("wasserstein", 256)])
@pytest.mark.parametrize("batch", [32, 128])
def test_embed_batched_padding_is_invisible(name, width, batch):
    e = _make(name)
    fv = _fvals(b=77, n=width, seed=3)       # 77 = 2 * 32 + 13
    one = e.embed(fv)
    assert torch.equal(e.embed_batched(fv, batch_size=batch), one)


@pytest.mark.parametrize("embedder", ["qmc", "wasserstein"])
def test_servable_embed_bit_equal_to_jax(embedder):
    """Servable.embed through the padded palette in both packages."""
    width = N if embedder == "qmc" else 256
    kw = dict(name="t", n_dims=N, p=1.0 if embedder == "qmc" else 2.0,
              embedder=embedder, segment_capacity=128, insert_chunk=64,
              chunk_sizes=(8, 32))
    jsv = JRegistry().register(JSpec(**kw))
    tsv = ServableRegistry(device="cpu").register(ServableSpec(**kw))
    fv = _fvals(b=200, n=width, seed=5)
    np.testing.assert_array_equal(tsv.embed(fv).numpy(),
                                  np.asarray(jsv.embed(fv)))
    np.testing.assert_array_equal(tsv.nodes(), np.asarray(jsv.nodes()))


def test_wasserstein_embedding_distance_matches_w2():
    e = _make("wasserstein", 512)
    mu = np.asarray([0.0, 0.4, -0.8], np.float32)
    sig = np.asarray([1.0, 0.6, 0.3], np.float32)
    emb = e.embed_gaussian(mu, sig).numpy()
    for i in range(3):
        for j in range(i + 1, 3):
            est = float(np.linalg.norm(emb[i] - emb[j]))
            true = float(jw.gaussian_w2(mu[i], sig[i], mu[j], sig[j]))
            assert abs(est - true) < 0.03 + 0.05 * true


def test_wasserstein_empirical_matches_parametric():
    """Raw draws land next to the closed-form quantile embedding of the
    same distribution: one index serves both input forms."""
    e = _make("wasserstein", 64)
    rng = np.random.default_rng(8)
    mu, sig = 0.3, 0.7
    samples = (mu + sig * rng.normal(size=(1, 8000))).astype(np.float32)
    emp = e.embed(samples).numpy()[0]
    par = e.embed_gaussian(np.float32(mu), np.float32(sig)).numpy()
    assert np.linalg.norm(emp - par) < 0.05
    u = e.nodes()
    assert u.min() >= e.clip and u.max() <= 1.0 - e.clip
    assert e.volume == pytest.approx(1.0 - 2 * e.clip)


@pytest.mark.parametrize("clip", [0.0, 0.5, -0.1, 0.7])
def test_wasserstein_clip_validation(clip):
    with pytest.raises(ValueError, match="clip"):
        _make("wasserstein", params={"clip": clip})


def test_registry_names_and_types():
    assert set(embedder_names()) >= {"basis", "qmc", "wasserstein"}
    assert isinstance(_make("qmc"), QMCEmbedder)
    assert isinstance(_make("wasserstein"), WassersteinEmbedder)


@pytest.mark.parametrize("name,params", [
    ("qmc", {"interval": [0.0, 2.0], "sequence": "halton", "skip": 8,
             "seed": 0}),
    ("qmc", {"interval": [0.0, 1.0], "sequence": "mc", "skip": 64,
             "seed": 5}),
    ("wasserstein", {"clip": 0.01, "sequence": "halton"}),
])
def test_params_round_trip_through_make_embedder(name, params):
    e = _make(name, p=1.0, params=params)
    assert e.params() == params
    again = _make(name, p=1.0, params=e.params())
    np.testing.assert_array_equal(again.nodes(), e.nodes())
    assert again.describe() == e.describe()
    # the JAX package reads the same params
    je = j_make(name, N, p=1.0, params=params)
    assert je.params() == params
    if params.get("sequence") != "mc":
        np.testing.assert_array_equal(np.asarray(je.nodes()), e.nodes())
