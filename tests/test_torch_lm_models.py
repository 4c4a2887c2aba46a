"""The port's LM configs and models, every family, against the JAX
package's (``repro.configs``, ``repro.models``).

Parameters come from the JAX ``api.init`` through
``convert.lm_params_from_numpy``; tokens, patches and frames are numpy
draws from fixed seeds.  Tolerances: forward logits rtol 1e-4 atol 1e-5
(fp32, 4 layers: matmuls that sum in another order); decode logits the
same, its caches (every leaf: K/V, ring buffers, conv windows) atol
1e-5, the recurrent states (mamba2's ``ssm``, the RG-LRU's ``h``, sums of
32 steps' updates) rtol 1e-4 atol 1e-5; decode against the teacher-forced forward at the JAX
test's bar (``tests/test_models.py:47``, 2e-2 x scale); padded heads 1e-5
(``tests/test_models.py:100``).  The enc-dec decode reads cross K/V that
the JAX package cannot fill (it has no ``fill_cross_cache``), so its
cache is filled here from ``encode`` and the cross projections, as its
forward computes them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def _pair(arch, **changes):
    """The JAX and port smoke models of ``arch`` on the same weights."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **changes)
    cfg = dataclasses.replace(configs.smoke_config(arch), **changes)
    japi = jget_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return japi, params, api, model


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.modality == "vision":
        batch["patches"] = (rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_jax_package(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get in ("get_config", "smoke_config"):
        mine = getattr(configs, get)(arch)
        theirs = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine._layer_types() == theirs._layer_types()
        for prop in ("h_eff", "e_eff", "v_eff", "sub_quadratic", "d_inner",
                     "ssm_heads"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_matches_jax(arch):
    japi, params, api, model = _pair(arch)
    batch = _batch(api.cfg, 1)
    want, jaux = japi.forward(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, aux = api.forward(model, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    s_out = 32 + (api.cfg.frontend_len if api.cfg.modality == "vision"
                  else 0)
    assert got.shape == (2, s_out, api.cfg.v_eff)
    if api.cfg.family == "moe":
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def fill_jax_cross_cache(japi, params, jcache, frames):
    """The enc-dec cross K/V in a JAX cache, as its forward's ``_mem_kv``
    computes them from ``encode``."""
    mem = japi.encode(params, jnp.asarray(frames))
    cross = params["dec"]["cross"]
    return dict(jcache,
                ck=jnp.einsum("bsd,ldhk->lbshk", mem, cross["wk"]),
                cv=jnp.einsum("bsd,ldhk->lbshk", mem, cross["wv"]))


def cache_leaves(cache):
    """A cache's (key, leaf) pairs in the JAX tree's order, as numpy."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        cache))
    return [(path[-1].key, leaf) for path, leaf in flat]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_matches_jax(arch):
    """32 decode steps: logits and every cache leaf against the JAX
    package's at every step."""
    japi, params, api, model = _pair(arch)
    batch = _batch(api.cfg, 2)
    toks = batch["tokens"]
    jcache = japi.init_cache(2, 32)
    cache = api.init_cache(2, 32, device="cpu")
    if api.cfg.family == "encdec":
        jcache = fill_jax_cross_cache(japi, params, jcache, batch["frames"])
        with torch.no_grad():
            api.fill_cross_cache(model, cache,
                                 torch.as_tensor(batch["frames"]))
    dec = jax.jit(japi.decode_step)
    for t in range(32):
        want, jcache = dec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        with torch.no_grad():
            got, cache = api.decode_step(model, cache,
                                         torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")
    assert jax.tree.structure(jax.tree.map(np.asarray, jcache)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), cache))
    for (key, a), (_, b) in zip(cache_leaves(cache), cache_leaves(jcache)):
        assert a.shape == b.shape and a.dtype == b.dtype
        # the recurrent states sum 32 steps' updates: rtol as the logits
        np.testing.assert_allclose(a, b, atol=1e-5,
                                   rtol=1e-4 if key in ("ssm", "h") else 1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "glm4-9b", "internlm2-20b"])
def test_forward_decode_consistency(arch):
    """Sequential decode reproduces the teacher-forced logits (the JAX
    test's bar)."""
    cfg = configs.smoke_config(arch)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(3))
    b, s = 2, 32
    toks = torch.as_tensor(_batch(cfg, 3)["tokens"])
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": toks})
        cache = api.init_cache(b, s, device="cpu")
        outs = []
        for t in range(s):
            lg, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    scale = float(full.abs().max()) + 1e-6
    err = float((full - dec).abs().max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)


def test_padded_heads_masked():
    """Changing padded-head weights must not change the model function;
    and the padded model matches the JAX package's, forward and decode."""
    japi, params, api, model = _pair("llama3.2-3b", n_heads_pad=8)
    toks = _batch(api.cfg, 4, s=16)["tokens"]
    t = torch.as_tensor(toks)
    with torch.no_grad():
        lg1, _ = api.forward(model, {"tokens": t})
        for layer in model.layers:
            layer.attn.wq[:, api.cfg.n_heads:, :] += 7.0
            layer.attn.wo[api.cfg.n_heads:, :, :] += 7.0
        lg2, _ = api.forward(model, {"tokens": t})
        cache = api.init_cache(2, 16, device="cpu")
        dec, _ = api.decode_step(model, cache, t[:, :1], 0)
    assert float((lg1 - lg2).abs().max()) < 1e-5
    want, _ = japi.forward(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(lg1.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    jdec, _ = japi.decode_step(params, japi.init_cache(2, 16),
                               jnp.asarray(toks[:, :1]), jnp.int32(0))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_defaults_to_the_card(arch):
    api = get_model(configs.smoke_config(arch))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cache would go there")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(1, 8)


def test_param_counts_match_names():
    """The JAX test's analytic counts, and the module's allocated count:
    the analytic count plus the padded heads' rows of wq and wo."""
    expect = {"llama3.2-3b": 3.2e9, "glm4-9b": 9.4e9, "internlm2-20b": 19.9e9,
              "mistral-large-123b": 122.6e9, "mamba2-2.7b": 2.7e9,
              "arctic-480b": 477e9, "qwen2-moe-a2.7b": 14.3e9}
    for k, v in expect.items():
        n = configs.get_config(k).param_count()
        assert abs(n - v) / v < 0.02, (k, n)
    cfg = dataclasses.replace(configs.smoke_config("llama3.2-3b"),
                              n_heads_pad=8)
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    pad = cfg.n_layers * 2 * (cfg.h_eff - cfg.n_heads) * cfg.head_dim * \
        cfg.d_model
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + pad + norms
