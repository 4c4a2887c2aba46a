"""The port's RG-LRU block and hybrid family (recurrentgemma-2b: groups of
(RG-LRU, RG-LRU, local attention) and an RG-LRU tail) against the JAX
package's (``repro.models.rglru``, ``repro.models.model.make_hybrid``).

Weights come from the JAX ``api.init`` through ``convert``; inputs are
numpy draws from fixed seeds.  Tolerances: the loss and every gradient,
decode logits and the recurrent states rtol 1e-4 atol 1e-5, the ring
buffers atol 1e-5 (fp32 smoke config: matmuls that sum in another order);
the doubling scan against a sequential loop and the JAX
``associative_scan`` rtol 1e-5 atol 1e-6 (the same products in another
association); decode against the teacher-forced forward the JAX test's bar
(``tests/test_models.py:47``, 2e-2 x scale).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_support import (ATOL, RTOL, assert_decode_reproduces_forward,  # noqa: E402
                               assert_grads_match, batch, decode_all, pair,
                               run_train_launcher)
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model, rglru  # noqa: E402

ARCH = "recurrentgemma-2b"


def _ab(seed, b, s, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, bb


def _sequential(a, b):
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100, 2048])
def test_doubling_scan_equals_a_loop_and_the_jax_scan(s):
    a, b = _ab(s, 2, s, 5)
    got = rglru.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    torch.testing.assert_close(got, _sequential(torch.as_tensor(a),
                                                torch.as_tensor(b)),
                               rtol=1e-5, atol=1e-6)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_doubling_scan_gradients_equal_the_loops():
    a, b = _ab(3, 2, 37, 4)
    grads = []
    for scan in (rglru.linear_scan, _sequential):
        ta = torch.tensor(a, requires_grad=True)
        tb = torch.tensor(b, requires_grad=True)
        (scan(ta, tb) * torch.linspace(-1, 1, 37)[None, :, None]).sum() \
            .backward()
        grads.append((ta.grad, tb.grad))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_grads_match_jax():
    assert_grads_match(ARCH)


def test_decode_reproduces_the_forward():
    """The single-step RG-LRU update and the ring-buffer local attention
    reproduce the doubling scan and the windowed forward."""
    assert_decode_reproduces_forward(ARCH)


def test_decode_past_the_ring_buffers_wrap():
    """At the smoke window of 64, 80 decode steps wrap each group's ring
    buffer: logits every step and the final caches against the JAX
    package's decode, and the logits against the windowed forward over
    the 80 tokens."""
    japi, params, api, model = pair(ARCH)
    cfg = api.cfg
    assert cfg.local_window == 64
    toks = batch(cfg, 6, 2, 80)["tokens"]
    jcache = japi.init_cache(2, 80)
    dec = jax.jit(japi.decode_step)
    jlogits = []
    for t in range(80):
        lg, jcache = dec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        jlogits.append(np.asarray(lg[:, 0]))
    got, cache = decode_all(api, model, toks)
    assert cache["groups"]["k"].shape[2] == 64
    np.testing.assert_allclose(got.numpy(), np.stack(jlogits, axis=1),
                               rtol=RTOL, atol=ATOL)
    want = jax.tree.map(np.asarray, jcache)
    mine = jax.tree.map(lambda t: t.numpy(), cache)
    assert jax.tree.structure(want) == jax.tree.structure(mine)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": torch.as_tensor(toks)})
    scale = float(full.abs().max())
    assert float((full - got).abs().max()) < 2e-2 * max(scale, 1.0)


def test_cache_layout():
    """Groups and tail: 4 smoke layers are one group and a tail of one;
    recurrentgemma-2b's 26 are 8 groups and a tail of 2."""
    cfg = configs.smoke_config(ARCH)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    assert len(model.groups) == 1 and len(model.tail) == 1
    cache = api.init_cache(3, 16, device="cpu")
    assert cache["groups"]["k"].shape == (1, 3, 16, cfg.n_kv_heads,
                                          cfg.head_dim)
    assert cache["groups"]["rg1"]["h"].shape == (1, 3, cfg.lru_width)
    assert cache["groups"]["rg1"]["h"].dtype == torch.float32
    assert cache["tail"]["conv"].shape == (1, 3, cfg.d_conv - 1,
                                           cfg.lru_width)
    from repro_torch.models.model import _hy_counts
    assert _hy_counts(configs.get_config(ARCH)) == (8, 2)


def test_train_launcher_runs_the_family_on_cpu(tmp_path):
    run_train_launcher(ARCH, tmp_path)
