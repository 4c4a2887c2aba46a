"""The port's Mamba2 SSD block and ssm family (mamba2-2.7b) against the
JAX package's (``repro.models.ssm``).

Weights come from the JAX ``api.init`` through ``convert``; tokens are
numpy draws from fixed seeds.  Tolerances: the loss and every gradient
rtol 1e-4 atol 1e-5 (fp32 smoke config: einsums that sum in another
order, and the inter-chunk recurrence run as a loop where the JAX package
runs an associative scan); decode against the teacher-forced forward the
JAX test's bar (``tests/test_models.py:47``, 2e-2 x scale); the forward
at one chunk length against another rtol 1e-4 atol 1e-5.

At mamba2's own chunk length (256) the JAX SSD's gradients are not
finite: it takes ``exp(cs_i - cs_j)`` over every (i, j) pair and masks
j > i only after the exp, which overflows there, and its backward pass
computes 0 x inf.  The port masks before the exp; its gradients must be
finite, and equal the JAX package's wherever those are.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_lm_support import (ATOL, RTOL, assert_decode_reproduces_forward,  # noqa: E402
                               assert_grads_match, batch, loss_and_grads,
                               pair, run_train_launcher)
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model, ssm  # noqa: E402

ARCH = "mamba2-2.7b"


def test_grads_match_jax():
    assert_grads_match(ARCH)


def test_decode_reproduces_the_forward():
    """The O(1) decode recurrence reproduces the chunked SSD."""
    assert_decode_reproduces_forward(ARCH)


@pytest.mark.parametrize("chunk", [8, 32])
def test_forward_is_the_same_at_any_chunk_length(chunk):
    """The chunked algorithm is one function whatever the chunk: intra-chunk
    terms and the inter-chunk recurrence trade places."""
    cfg = configs.smoke_config(ARCH)
    model = get_model(cfg).init(torch.Generator().manual_seed(2))
    toks = torch.as_tensor(batch(cfg, 2, 2, 64)["tokens"])
    with torch.no_grad():
        want, _ = model({"tokens": toks})
        model.cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
        got, _ = model({"tokens": toks})
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_forward_needs_whole_chunks():
    cfg = configs.smoke_config(ARCH)
    model = get_model(cfg).init(torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="multiple"):
        model({"tokens": torch.zeros((1, cfg.ssm_chunk + 1),
                                     dtype=torch.int32)})


def test_causal_conv_is_the_shifted_sum():
    """The depthwise causal conv against conv1d with left padding."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 20, 6)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((6,)).astype(np.float32))
    want = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.transpose(1, 2), (3, 0)),
        w.T[:, None, :], b, groups=6).transpose(1, 2)
    torch.testing.assert_close(ssm.causal_conv(x, w, b), want, rtol=1e-5,
                               atol=1e-6)


def test_gradients_finite_at_the_configs_chunk_where_jax_overflows():
    """ssm_chunk 256 (mamba2-2.7b's), seq 256, batch 1: the JAX package's
    gradients hold non-finite entries; the port's are finite and allclose
    to the JAX ones wherever those are finite; the forward agrees."""
    japi, params, api, model = pair(ARCH, ssm_chunk=256)
    data = batch(api.cfg, 5, 1, 256)
    (jl, _, jg), (tl, _, tg) = loss_and_grads(japi, params, api, model, data)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    bad = {jax.tree_util.keystr(p): int((~np.isfinite(g)).sum())
           for p, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert bad["['layers']['mamba']['in_proj']"] > 0, bad
    assert sum(bad.values()) > 0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree.leaves(tg)):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(got).all(), name
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_decode_writes_its_states_in_place():
    cfg = configs.smoke_config(ARCH)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(1))
    cache = api.init_cache(2, 8, device="cpu")
    conv, state = cache["conv"].data_ptr(), cache["ssm"].data_ptr()
    assert cache["ssm"].dtype == torch.float32
    with torch.no_grad():
        _, out = api.decode_step(model, cache,
                                 torch.ones((2, 1), dtype=torch.int32), 0)
    assert out is cache
    assert out["conv"].data_ptr() == conv and out["ssm"].data_ptr() == state
    assert float(out["ssm"].abs().sum()) > 0.0


def test_train_launcher_runs_the_family_on_cpu(tmp_path):
    run_train_launcher(ARCH, tmp_path)
