"""The port's encoder-decoder family (seamless-m4t-medium: a stub audio
frontend, a bidirectional encoder and a text decoder with cross
attention) against the JAX package's (``repro.models.model.make_encdec``),
and the enc-dec batches of ``data/pipeline.py``.

Weights come from the JAX ``api.init`` through ``convert``; tokens and
frames are numpy draws from fixed seeds.  Tolerances: the encoder's
memory, the loss and every gradient rtol 1e-4 atol 1e-5 (fp32 smoke
config: matmuls that sum in another order); the decode with a filled
cross cache against the JAX forward's teacher-forced logits rtol 1e-4
atol 1e-4 (fp32: one token's attention against the whole sequence's
masked softmax, 32 steps); pipeline batches bit-equal (both numpy).

The JAX decode reads cross K/V from its cache, and its docstring names
``fill_cross_cache``, but no such function exists there and its
``init_cache`` leaves them zero.  The port's ``fill_cross_cache`` writes
them as the forward computes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_support import (ATOL, RTOL, assert_grads_match, batch,  # noqa: E402
                               pair, run_train_launcher, to_jax)
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402

ARCH = "seamless-m4t-medium"


def test_grads_match_jax():
    """The loss and every gradient, the encoder's through the cross
    attention's memory."""
    assert_grads_match(ARCH)


def test_encode_matches_jax():
    japi, params, api, model = pair(ARCH)
    frames = batch(api.cfg, 4)["frames"]
    want = japi.encode(params, jnp.asarray(frames))
    with torch.no_grad():
        got = api.encode(model, torch.as_tensor(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_decode_with_a_filled_cross_cache_matches_the_jax_forward():
    """fill_cross_cache, then 32 decode steps: the logits of the JAX
    package's teacher-forced forward at every position."""
    japi, params, api, model = pair(ARCH)
    data = batch(api.cfg, 5)
    want, _ = japi.forward(params, to_jax(data))
    toks = data["tokens"]
    cache = api.init_cache(2, 32, device="cpu")
    assert float(cache["ck"].abs().max()) == 0.0
    got = []
    with torch.no_grad():
        filled = api.fill_cross_cache(model, cache,
                                      torch.as_tensor(data["frames"]))
        assert filled is cache
        for t in range(32):
            lg, cache = api.decode_step(model, cache,
                                        torch.as_tensor(toks[:, t:t + 1]), t)
            got.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_cross_cache_holds_the_forwards_memory_projections():
    """ck / cv of layer i are the JAX forward's _mem_kv of its layer i:
    the encoder's memory through that layer's cross wk / wv."""
    japi, params, api, model = pair(ARCH)
    frames = batch(api.cfg, 6)["frames"]
    cache = api.init_cache(2, 4, device="cpu")
    with torch.no_grad():
        api.fill_cross_cache(model, cache, torch.as_tensor(frames))
    mem = japi.encode(params, jnp.asarray(frames))
    cross = params["dec"]["cross"]
    for key, w in (("ck", "wk"), ("cv", "wv")):
        want = jnp.einsum("bsd,ldhk->lbshk", mem, cross[w])
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_cache_takes_the_encoders_length():
    cfg = configs.smoke_config(ARCH)
    from repro_torch.models import get_model
    api = get_model(cfg)
    assert api.init_cache(2, 8, device="cpu")["ck"].shape[2] == \
        cfg.frontend_len
    assert api.init_cache(2, 8, device="cpu", enc_len=5)["cv"].shape == \
        (cfg.n_layers, 2, 5, cfg.n_kv_heads, cfg.head_dim)


def test_pipeline_frames_equal_the_jax_package():
    """Enc-dec batches: tokens and frames (one frame a token, drawn after
    the tokens) bit-equal to the JAX pipeline's."""
    cfg, jcfg = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    mine = SyntheticPipeline(cfg, ShapeConfig("t", 64, 4, "train"), seed=3)
    theirs = jpipeline.SyntheticPipeline(
        jcfg, JShapeConfig("t", 64, 4, "train"), seed=3)
    for step in (0, 5, 6):
        a, b = mine.get_batch(step), theirs.get_batch(step)
        assert a.keys() == b.keys() == {"tokens", "frames"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    assert a["frames"].shape == (4, 64, cfg.d_model)


def test_train_launcher_runs_the_family_on_cpu(tmp_path):
    run_train_launcher(ARCH, tmp_path)
