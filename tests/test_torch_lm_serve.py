"""The port's serve step with the W^2-LSH signature against the JAX
package's (``repro.runtime.steps.make_serve_step``), the signature's
properties, and the training launcher's device rule.

Parameters and hashing state come from the JAX package through
``convert``.  Tolerances: logits rtol 1e-4 atol 1e-5 (as the forward);
the greedy token equal wherever the JAX logits' top two differ by more
than 1e-5 x scale; signatures equal except where the JAX projection lies
within 1e-5 of an integer (counted, and asserted apart nowhere else): the
hash is a floor, so a projection within rounding of an integer may land on
either side.  The port's logits feed its own signature, so a row is
compared where both embeddings are equal (a CDF within rounding of a node
moves one coordinate a support step); at most 1/16 of the rows may
differ there.  On the JAX logits the port's signature goes through the
same embedding and K1's plain version (product, division by r, + b,
floor) and is held to the same rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import wasserstein as jwass  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import wasserstein  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import steps as rt  # noqa: E402

MARGIN = 1e-5


def _setup(arch="llama3.2-3b", n_hashes=16, r=1.0):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    japi, api = jget_model(jcfg), get_model(cfg)
    params = japi.init(jax.random.PRNGKey(0))
    model = api.init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    jlsh = jsteps.LshServeParams.create(jax.random.PRNGKey(1), jcfg,
                                        n_hashes=n_hashes, r=r)
    lsh = convert.lsh_serve_params_from_numpy(
        *(np.asarray(t) for t in (jlsh.nodes, jlsh.volume, jlsh.support,
                                  jlsh.alpha, jlsh.b)), jlsh.r, device="cpu")
    return japi, params, jlsh, api, model, lsh


def _jax_projection(jlsh, logits):
    emb = jwass.w2_embedding_logits(logits[:, 0, :], jlsh.support,
                                    jlsh.nodes, jlsh.volume)
    return np.asarray(emb @ jlsh.alpha / jlsh.r + jlsh.b)


def _check_signature(got, want, proj):
    """Equal except at a counted floor boundary; returns the count."""
    near = np.abs(proj - np.round(proj)) <= MARGIN
    apart = (got != want) & ~near
    assert not apart.any(), f"{int(apart.sum())} hashes apart off a boundary"
    return int(near.sum())


def test_serve_step_matches_jax():
    """24 greedy decode steps through both serve steps, from the same
    prompt token: logits, next tokens and signatures every step."""
    japi, params, jlsh, api, model, lsh = _setup()
    cfg = api.cfg
    jserve = jax.jit(jsteps.make_serve_step(japi, japi.cfg, jlsh))
    serve = rt.make_serve_step(api, cfg, lsh)
    b, t = 4, 24
    jcache = japi.init_cache(b, t)
    cache = api.init_cache(b, t, device="cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, 1)).astype(np.int32)
    boundary = compared = 0
    for pos in range(t):
        jout, jcache = jserve(params, jcache, jnp.asarray(toks),
                              jnp.int32(pos))
        out, cache = serve(model, cache, torch.tensor(toks), pos)
        jl = np.asarray(jout["logits"])
        np.testing.assert_allclose(out["logits"].numpy(), jl, rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {pos}")
        scale = float(np.abs(jl).max())
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * scale
        jn = np.asarray(jout["next"])
        np.testing.assert_array_equal(out["next"].numpy()[clear], jn[clear])
        assert out["lsh_sig"].dtype == torch.int32
        assert out["lsh_sig"].shape == (b, lsh.alpha.shape[1])
        # the port's own logits feed its signature: the embedding's node
        # counts must agree for the rule to apply, so compare on rows whose
        # embeddings are equal, and on JAX's logits through the port
        emb = wasserstein.w2_embedding_logits(
            out["logits"][:, 0, :], lsh.support, lsh.nodes, lsh.volume)
        jemb = np.asarray(jwass.w2_embedding_logits(
            jout["logits"][:, 0, :], jlsh.support, jlsh.nodes, jlsh.volume))
        same = (emb.numpy() == jemb).all(axis=1)
        proj = _jax_projection(jlsh, jout["logits"])
        want = np.asarray(jout["lsh_sig"])
        boundary += _check_signature(out["lsh_sig"].numpy()[same],
                                     want[same], proj[same])
        compared += int(same.sum())
        on_jax = rt.lsh_signature(lsh, torch.tensor(jl))
        boundary += _check_signature(on_jax.numpy(), want, proj)
        toks = jn.reshape(b, 1)
    # a row whose logits put a CDF within rounding of a node differs in one
    # embedding coordinate (a support step of 2 / V): few do (1 of 96 here)
    assert compared >= b * t - b * t // 16, compared
    assert boundary <= b * t * lsh.alpha.shape[1] // 100, boundary


def test_identical_rows_give_identical_signatures():
    """tests/test_system.py:57's property on the port: identical inputs
    collide on every hash, different ones no more often."""
    _, _, _, api, model, lsh = _setup(n_hashes=64, r=0.2)
    serve = rt.make_serve_step(api, api.cfg, lsh)
    cache = api.init_cache(4, 16, device="cpu")
    toks = torch.tensor([[1], [1], [7], [300]], dtype=torch.int32)
    out, cache = serve(model, cache, toks, 0)
    sig = out["lsh_sig"]
    same = float((sig[0] == sig[1]).float().mean())
    diff = float((sig[0] == sig[3]).float().mean())
    assert same == 1.0
    assert diff <= same


def test_lsh_params_create_on_the_generator_device():
    """LshServeParams.create: Sobol nodes equal to the JAX package's, alpha
    (N, K) and b (K,) in [0, 1) from the generator, a support grid of the
    vocab's size on [-1, 1]."""
    cfg = configs.smoke_config("llama3.2-3b")
    lsh = rt.LshServeParams.create(torch.Generator().manual_seed(3), cfg,
                                   n_embed=64, n_hashes=16, r=0.5)
    jlsh = jsteps.LshServeParams.create(jax.random.PRNGKey(3),
                                        jconfigs.smoke_config("llama3.2-3b"),
                                        n_embed=64, n_hashes=16, r=0.5)
    np.testing.assert_array_equal(lsh.nodes.numpy(), np.asarray(jlsh.nodes))
    assert lsh.volume == pytest.approx(float(jlsh.volume))
    assert lsh.alpha.shape == (64, 16) and lsh.b.shape == (16,)
    assert float(lsh.b.min()) >= 0.0 and float(lsh.b.max()) < 1.0
    np.testing.assert_allclose(lsh.support.numpy(), np.asarray(jlsh.support),
                               atol=1e-6)
    assert lsh.r == 0.5


def test_serve_step_without_lsh_has_no_signature():
    _, _, _, api, model, _ = _setup()
    serve = rt.make_serve_step(api, api.cfg)
    cache = api.init_cache(2, 4, device="cpu")
    out, _ = serve(model, cache, torch.ones((2, 1), dtype=torch.int32), 0)
    assert set(out) == {"logits", "next"}


def test_train_launcher_runs_on_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--steps", "6", "--seq-len", "32",
            "--batch", "4", "--ckpt", str(tmp_path)]
    r1 = train.main(args)
    assert r1.resumed_from is None and len(r1.losses) == 6
    assert np.isfinite(r1.losses).all()
    r2 = train.main(args[:3] + ["8"] + args[4:])
    assert r2.resumed_from == 6 and len(r2.losses) == 2
    out = capsys.readouterr().out
    assert "[train] done: steps=6" in out and "resumed_from=6" in out


def test_train_launcher_needs_a_card_unless_asked(tmp_path):
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the launcher would train")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--ckpt", str(tmp_path)])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_and_the_decode_bound(kind):
    from repro.launch import roofline as jroofline
    from repro_torch.launch import roofline
    n = configs.get_config("llama3.2-3b").active_param_count()
    assert roofline.model_flops(kind, n, 8, 2048) == jroofline.model_flops(
        kind, n, 8, 2048)
    # bf16 matrix products are held to the tensor cores' rate, not fp32's
    ops = roofline.model_flops(kind, n, 8, 2048)
    s, by = roofline.bound_by(0.0, ops, roofline.BF16_TENSOR_OPS_PER_S)
    assert by == "operations"
    assert s == ops / roofline.BF16_TENSOR_OPS_PER_S
    assert roofline.bound_by(0.0, ops)[0] == ops / roofline.FP32_OPS_PER_S
    nbytes = roofline.HBM_BYTES_PER_S * 2 * s
    assert roofline.bound_by(nbytes, ops, roofline.BF16_TENSOR_OPS_PER_S) == (
        2 * s, "bytes")
