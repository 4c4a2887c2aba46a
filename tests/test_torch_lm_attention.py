"""The port's attention against the JAX package's (``repro.models.common``)
and against its own dense path: the blockwise online softmax at S = 2,048,
its gradients, the layer's switch to it, RoPE and M-RoPE.

Inputs are numpy draws from fixed seeds, fed to both packages.
Tolerances: the JAX package's own for blockwise against dense (2e-5
values, 5e-4 gradients, 3e-5 through the layer); port against JAX on the
same inputs 2e-5 (fp32, the same per-block order of operations, einsums
that may sum in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.models import common, get_model  # noqa: E402


def _qkv(seed, b, s, h, hd):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
                 for _ in range(3))


def _dense(q, k, v, window=0):
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = j <= i
    if window > 0:
        mask = mask & (j > i - window)
    scores = torch.where(mask, scores, common.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


@pytest.mark.parametrize("window", [0, 512])
def test_flash_matches_dense(window):
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 2, 2048, 4, 32))
    with torch.no_grad():
        out = common._flash_attention(q, k, v, window=window, block_k=512)
        ref = _dense(q, k, v, window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [0, 512])
def test_flash_matches_jax(window):
    qn, kn, vn = _qkv(1, 1, 2048, 2, 32)
    want = jcommon._flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                    jnp.asarray(vn), window=window,
                                    block_k=512)
    with torch.no_grad():
        got = common._flash_attention(torch.as_tensor(qn),
                                      torch.as_tensor(kn),
                                      torch.as_tensor(vn), window=window,
                                      block_k=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_gradients_match_dense():
    """Autograd through the checkpointed blocks == through dense attention,
    for q, k and v."""
    qn, kn, vn = _qkv(2, 1, 2048, 2, 16)
    grads = []
    for fn in (lambda q, k, v: common._flash_attention(q, k, v, block_k=512),
               _dense):
        q, k, v = (torch.tensor(a, requires_grad=True) for a in (qn, kn, vn))
        fn(q, k, v).sum().backward()
        grads.append([t.grad.numpy() for t in (q, k, v)])
    for g1, g2 in zip(*grads):
        np.testing.assert_allclose(g1, g2, atol=5e-4, rtol=5e-4)


def test_attention_uses_flash_above_threshold(monkeypatch):
    """The layer at S = FLASH_MIN_SEQ (blockwise) equals its dense path at
    the same weights, and the JAX layer on the same weights."""
    cfg = smoke_config("glm4-9b")
    attn = common.Attention(torch.Generator().manual_seed(0), cfg)
    s = common.FLASH_MIN_SEQ
    rng = np.random.default_rng(3)
    xn = (rng.standard_normal((1, s, cfg.d_model)) * 0.1).astype(np.float32)
    x = torch.as_tensor(xn)
    pos = torch.arange(s, dtype=torch.int32)[None, :]
    cos, sin = common.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    with torch.no_grad():
        out_flash = common.attention(attn, cfg, x, cos, sin)
        monkeypatch.setattr(common, "FLASH_MIN_SEQ", s + 1)
        out_dense = common.attention(attn, cfg, x, cos, sin)
    np.testing.assert_allclose(out_flash.numpy(), out_dense.numpy(),
                               atol=3e-5, rtol=3e-5)
    jcfg = jsmoke_config("glm4-9b")
    jp = {n: jnp.asarray(getattr(attn, n).detach().numpy())
          for n in ("wq", "wk", "wv", "wo")}
    jpos = jnp.arange(s, dtype=jnp.int32)[None, :]
    jcos, jsin = jcommon.rope_angles(jpos, jcfg.head_dim, jcfg.rope_theta)
    want = jcommon.attention(jp, jcfg, jnp.asarray(xn), jcos, jsin)
    np.testing.assert_allclose(out_flash.numpy(), np.asarray(want),
                               atol=3e-5, rtol=3e-5)


def test_rope_is_rotation():
    """RoPE preserves norms and relative-position inner products."""
    hd = 64
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((1, 8, 2, hd)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None, :]
    cos, sin = common.rope_angles(pos, hd, 10000.0)
    y = common.apply_rope(x, cos, sin)
    np.testing.assert_allclose(torch.linalg.norm(y, dim=-1).numpy(),
                               torch.linalg.norm(x, dim=-1).numpy(),
                               rtol=1e-5)
    q, k = (torch.as_tensor(rng.standard_normal(hd).astype(np.float32))
            for _ in range(2))

    def ip(m, n):
        c, s_ = common.rope_angles(torch.tensor([[m, n]]), hd, 10000.0)
        qk = common.apply_rope(torch.stack([q, k])[None, :, None, :], c, s_)
        return float(torch.dot(qk[0, 0, 0], qk[0, 1, 0]))
    assert abs(ip(3, 5) - ip(10, 12)) < 1e-3


def test_mrope_text_equals_rope():
    """For text (t = h = w positions), M-RoPE coincides with RoPE."""
    hd = 128
    pos = torch.arange(16, dtype=torch.int32)[None, :]
    pos3 = pos[None].expand(3, 1, 16)
    c1, s1 = common.rope_angles(pos, hd, 1e6)
    c2, s2 = common.rope_angles(pos3, hd, 1e6, (16, 24, 24))
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6)


@pytest.mark.parametrize("sections", [(), (16, 24, 24)])
def test_rope_tables_match_jax(sections):
    """cos / sin tables against the JAX package's at 2,048 positions, with
    distinct t / h / w rows for M-RoPE; and apply_rope on the same x."""
    hd, s = 128, 2048
    rng = np.random.default_rng(5)
    if sections:
        pos = rng.integers(0, s, (3, 1, s)).astype(np.int32)
    else:
        pos = np.arange(s, dtype=np.int32)[None, :]
    jc, js = jcommon.rope_angles(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = common.rope_angles(torch.as_tensor(pos), hd, 1e6, sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = rng.standard_normal((1, s, 2, hd)).astype(np.float32)
    want = jcommon.apply_rope(jnp.asarray(x), jc, js)
    got = common.apply_rope(torch.as_tensor(x), torch.tensor(np.asarray(jc)),
                            torch.tensor(np.asarray(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_jax_with_padded_heads(window):
    """attention_decode with padded query heads (the static permutation)
    and, with a window, the ring buffer past its wrap, against the JAX
    package's on the same weights and caches."""
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), n_heads_pad=8)
    jcfg = dataclasses.replace(jsmoke_config("llama3.2-3b"), n_heads_pad=8)
    attn = common.Attention(torch.Generator().manual_seed(1), cfg)
    jp = {n: jnp.asarray(getattr(attn, n).detach().numpy())
          for n in ("wq", "wk", "wv", "wo")}
    rng = np.random.default_rng(6)
    t = 16
    shape = (2, t, cfg.n_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    for pos in (0, 5, 15, 20):
        if window == 0 and pos >= t:
            continue
        x = (rng.standard_normal((2, 1, cfg.d_model)) * 0.3).astype(
            np.float32)
        ppos = np.full((2, 1), pos, np.int32)
        jc, js = jcommon.rope_angles(jnp.asarray(ppos), cfg.head_dim,
                                     cfg.rope_theta)
        want, jk, jv = jcommon.attention_decode(
            jp, jcfg, jnp.asarray(x), jk, jv, jnp.int32(pos), jc, js,
            window=window)
        tc, ts = common.rope_angles(torch.as_tensor(ppos), cfg.head_dim,
                                    cfg.rope_theta)
        with torch.no_grad():
            got, tk, tv = common.attention_decode(
                attn, cfg, torch.as_tensor(x), tk, tv, pos, tc, ts,
                window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_params_round_trip(arch):
    """convert.lm_params_to_numpy inverts lm_params_from_numpy, bf16
    leaves included (as their uint16 bits), for every family; the tree has
    the JAX ``api.init`` tree's paths and shapes."""
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="bfloat16")
    m1 = get_model(cfg).init(torch.Generator().manual_seed(0))
    m2 = get_model(cfg).init(torch.Generator().manual_seed(1))
    tree = convert.lm_params_to_numpy(m1)
    jcfg = dataclasses.replace(jsmoke_config(arch), param_dtype="bfloat16")
    want = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
        assert tuple(a.shape) == b.shape
    assert tree["embed"]["tok"].dtype == np.uint16
    convert.lm_params_from_numpy(m2, jax_bf16(tree))
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n


def jax_bf16(tree):
    """uint16 bit leaves -> ml_dtypes bfloat16 arrays (as JAX hands them)."""
    if isinstance(tree, dict):
        return {k: jax_bf16(v) for k, v in tree.items()}
    return tree.view(jnp.bfloat16) if tree.dtype == np.uint16 else tree
