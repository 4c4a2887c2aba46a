"""Shared setup of the per-family LM parity tests (``test_torch_lm_moe``,
``_ssm``, ``_hybrid``, ``_encdec``): one parameter set in both packages, a
numpy batch, and one train step's loss and gradients through both loss
functions.

The bars are ``tests/test_torch_lm_models.py``'s: rtol 1e-4, atol 1e-5
(fp32 smoke configs; matmuls and reductions that may sum in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.runtime import steps as jsteps
from repro_torch import configs, convert
from repro_torch.models import get_model
from repro_torch.runtime import steps as rt

RTOL, ATOL = 1e-4, 1e-5


def pair(arch, **changes):
    """The JAX and port smoke models of ``arch`` (with ``changes``) on the
    same weights: (japi, params, api, model)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **changes)
    cfg = dataclasses.replace(configs.smoke_config(arch), **changes)
    japi = jget_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return japi, params, api, model


def batch(cfg, seed, b=2, s=32):
    """Tokens, and the enc-dec's frames (the JAX tests' frontend_len of
    them), drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def loss_and_grads(japi, params, api, model, data):
    """One step's loss, metrics and gradients in both packages:
    ((loss, metrics, grads tree) of JAX, the same of the port), numpy."""
    vg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(japi, japi.cfg),
                                    has_aux=True))
    (jl, jm), jg = vg(params, to_jax(data))
    loss, metrics = rt.accumulate_grads(rt.make_loss_fn(api, api.cfg), model,
                                        to_torch(data), 1)
    grads = convert.lm_params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    return ((float(jl), {k: float(v) for k, v in jm.items()},
             jax.tree.map(np.asarray, jg)),
            (float(loss), {k: float(v) for k, v in metrics.items()}, grads))


def assert_grads_match(arch, seed=1, b=4, s=32, **changes):
    """The loss, its aux term and every gradient of one step against the
    JAX package's, at RTOL / ATOL."""
    japi, params, api, model = pair(arch, **changes)
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads(
        japi, params, api, model, batch(api.cfg, seed, b, s))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=RTOL, atol=ATOL)
    assert jax.tree.structure(jg) == jax.tree.structure(tg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    for (path, want), got in zip(flat, jax.tree.leaves(tg)):
        assert np.isfinite(got).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    return tm


def decode_all(api, model, toks, cache_len=None):
    """Feed ``toks`` (B, S) token by token through the port's decode:
    the (B, S, V) logits and the cache."""
    b, s = toks.shape
    cache = api.init_cache(b, cache_len or s, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(s):
            lg, cache = api.decode_step(model, cache,
                                        torch.as_tensor(toks[:, t:t + 1]), t)
            outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), cache


def assert_decode_reproduces_forward(arch, seed=3, b=2, s=32):
    """Sequential decode reproduces the teacher-forced logits, at the JAX
    test's bar (``tests/test_models.py:47``: 2e-2 x scale)."""
    cfg = configs.smoke_config(arch)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(seed))
    toks = batch(cfg, seed, b, s)["tokens"]
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": torch.as_tensor(toks)})
    dec, _ = decode_all(api, model, toks)
    scale = float(full.abs().max()) + 1e-6
    err = float((full - dec).abs().max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)
    return err, scale


def run_train_launcher(arch, tmp_path):
    """``launch.train --arch ARCH`` (its smoke config) on the CPU: 3 steps
    of 2 x 32 tokens, finite losses."""
    from repro_torch.launch import train
    r = train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                    "--seq-len", "32", "--batch", "2", "--ckpt",
                    str(tmp_path)])
    assert r.final_step == 3 and len(r.losses) == 3
    assert np.isfinite(r.losses).all()
    return r
