"""The port's training substrate against the JAX package's
(``repro.runtime.steps``, ``repro.optim.adamw``, ``repro.data.pipeline``):
the chunked-CE loss and its gradients, AdamW, the schedules, the data
stream, and the port's own properties of ``tests/test_train.py`` (the loss
falls, accumulation is equivalent, the driver resumes).

Tolerances: loss rtol 1e-5 and gradients rtol 1e-4 atol 1e-6 (fp32: the
same chunked order, reductions that may sum in another order); AdamW fed
the same numpy gradients rtol 1e-6 on parameters and moments (elementwise
fp32: pow, sqrt and the global norm's sum order may differ by an ulp);
schedules bit-equal, the cosine's at rtol 1e-6 (the same f32 formula;
XLA's and torch's cos differ by an ulp at 3 of the 121 steps); the
pipeline bit-equal (both numpy).  The port-only bars are the JAX tests'.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import BigramLM, SyntheticPipeline  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import steps as rt  # noqa: E402
from repro_torch.runtime.driver import DriverConfig, train_loop  # noqa: E402


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("accum", [1, 4])
def test_loss_and_grads_match_jax(accum):
    """One step's loss and gradients: the port's accumulate_grads over
    make_loss_fn against jax.value_and_grad of the JAX make_loss_fn over
    the same interleaved micro-batches (64 tokens: 8 CE chunks)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3.2-3b"),
                               grad_accum=accum)
    cfg = dataclasses.replace(configs.smoke_config("llama3.2-3b"),
                              grad_accum=accum)
    japi = jget_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 64)).astype(np.int32)

    vg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(japi, jcfg),
                                    has_aux=True))
    lsum, gsum = 0.0, None
    for i in range(accum):
        (l, _), g = vg(params, {"tokens": jnp.asarray(toks[i::accum])})
        lsum = lsum + l
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    want_loss = lsum / accum
    want = jax.tree.map(lambda g: g / accum, gsum) if accum > 1 else gsum

    loss, metrics = rt.accumulate_grads(rt.make_loss_fn(api, cfg), model,
                                        {"tokens": torch.as_tensor(toks)},
                                        accum)
    got = convert.lm_params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(metrics) == {"ce", "aux"}
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(got)
    for a, b in zip(_leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_on_shared_grads(moments):
    """Three AdamW steps fed the same numpy gradients: parameters, moments
    and the step's metrics against the JAX package's."""
    rng = np.random.default_rng(2)
    shapes = {"w": (16, 8), "b": (8,), "e": (32, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jcfg = jadamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=moments)
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          moment_dtype=moments)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jadamw.init(jcfg, jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tst = adamw.init(cfg, tp)
    for step in range(3):
        g = {k: (rng.standard_normal(s) * 10 ** (step - 1)).astype(np.float32)
             for k, s in shapes.items()}
        jp, jst, jm = jadamw.update(jcfg, {k: jnp.asarray(v)
                                           for k, v in g.items()}, jst, jp)
        tp, tst, tm = adamw.update(cfg, {k: torch.tensor(v)
                                         for k, v in g.items()}, tst, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    tst[mom][k].float().numpy(),
                    np.asarray(jst[mom][k]).astype(np.float32),
                    rtol=1e-6 if moments == "float32" else 1e-2,
                    atol=1e-12)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    jcfg = jadamw.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            schedule=schedule)
    cfg = adamw.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          schedule=schedule)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.schedule_lr(jcfg, s))(
        jnp.asarray(steps)))
    got = np.array([float(adamw.schedule_lr(cfg, torch.tensor(int(s))))
                    for s in steps], np.float32)
    # bit-equal but for the cosine, whose cos may differ by an ulp
    np.testing.assert_allclose(got, want, atol=0,
                               rtol=1e-6 if schedule == "cosine" else 0)
    assert float(adamw.schedule_lr(cfg, 0)) == 0.0
    assert abs(float(adamw.schedule_lr(cfg, 10)) - 1e-3) < 1e-9


def test_chunked_ce_equals_plain_cross_entropy():
    """make_loss_fn's chunked CE equals cross_entropy over the full logits
    with the last position dropped, and the JAX cross_entropy."""
    cfg = configs.smoke_config("llama3.2-3b")
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 64)))
    with torch.no_grad():
        loss, m = rt.make_loss_fn(api, cfg)(model, {"tokens": toks})
        full, _ = api.forward(model, {"tokens": toks})
    plain = rt.cross_entropy(full[:, :-1], toks[:, 1:])
    np.testing.assert_allclose(float(m["ce"]), float(plain), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)
    want = jsteps.cross_entropy(jnp.asarray(full[:, :-1].numpy()),
                                jnp.asarray(toks[:, 1:].numpy()))
    np.testing.assert_allclose(float(plain), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-vl-2b"])
def test_pipeline_batches_equal_the_jax_package(arch):
    cfg, jcfg = configs.smoke_config(arch), jconfigs.smoke_config(arch)
    mine = SyntheticPipeline(cfg, ShapeConfig("t", 64, 4, "train"), seed=3)
    theirs = jpipeline.SyntheticPipeline(
        jcfg, JShapeConfig("t", 64, 4, "train"), seed=3)
    for step in (0, 17, 18):
        a, b = mine.get_batch(step), theirs.get_batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    lm, jlm = BigramLM(64, seed=1, branch=4), jpipeline.BigramLM(
        64, seed=1, branch=4)
    np.testing.assert_array_equal(lm.table, jlm.table)
    np.testing.assert_array_equal(lm.sample(np.random.default_rng(2), 8, 32),
                                  jlm.sample(np.random.default_rng(2), 8, 32))


def _tiny_setup(accum=1, seed=0):
    """The JAX test's tiny setup (2 layers, vocab 64, bigram data)."""
    cfg = dataclasses.replace(configs.smoke_config("llama3.2-3b"),
                              n_layers=2, vocab_size=64, grad_accum=accum)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(seed))
    opt_cfg = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100,
                              weight_decay=0.0)
    opt = adamw.init(opt_cfg, dict(model.named_parameters()))
    step = rt.make_train_step(api, cfg, opt_cfg)
    lm = BigramLM(cfg.vocab_size, seed=1, branch=4)

    def get_batch(i):
        return {"tokens": torch.as_tensor(
            lm.sample(np.random.default_rng(i), 8, 32))}
    return cfg, api, model, opt, step, get_batch


def test_loss_decreases_on_bigram_data():
    cfg, api, model, opt, step, get_batch = _tiny_setup()
    losses = []
    for i in range(30):
        model, opt, m = step(model, opt, get_batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert np.isfinite(losses).all()


def test_grad_accum_equivalence():
    """accum=4 gives (nearly) the same update as accum=1 on the same
    batch."""
    _, _, m1, o1, step1, get_batch = _tiny_setup(accum=1)
    _, _, m4, o4, step4, _ = _tiny_setup(accum=4)
    batch = get_batch(0)
    m1, _, r1 = step1(m1, o1, batch)
    m4, _, r4 = step4(m4, o4, batch)
    d = max(float((a - b).abs().max())
            for a, b in zip(m1.state_dict().values(),
                            m4.state_dict().values()))
    assert d < 2e-5
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 1e-4


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_grads(remat):
    """Checkpointed blocks (full, or saving the matmul outputs) give the
    gradients of the plain blocks."""
    grads = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(configs.smoke_config("llama3.2-3b"),
                                  remat=mode)
        api = get_model(cfg)
        model = api.init(torch.Generator().manual_seed(6))
        toks = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (2, 32)))
        loss, _ = rt.accumulate_grads(rt.make_loss_fn(api, cfg), model,
                                      {"tokens": toks}, 1)
        grads[mode] = (float(loss), [p.grad.clone()
                                     for p in model.parameters()])
    assert grads["none"][0] == grads[remat][0]
    for a, b in zip(grads["none"][1], grads[remat][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_driver_resume(tmp_path):
    """Stop after N steps; a rerun resumes from the port's checkpoint and
    consumes the same stream."""
    cfg, api, model, opt, step, get_batch = _tiny_setup()
    dcfg = DriverConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=5,
                        log_every=100)
    r1 = train_loop(dcfg, step, model, opt, get_batch, log=lambda s: None)
    assert r1.resumed_from is None and len(r1.losses) == 10
    assert ckpt.steps(str(tmp_path)) == [5, 10]
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    # 'crash' and rerun: fresh parameters, but the driver resumes at 10
    _, _, model2, _, _, _ = _tiny_setup(seed=9)
    opt2 = adamw.init(adamw.OptConfig(), dict(model2.named_parameters()))
    dcfg2 = DriverConfig(total_steps=12, ckpt_dir=str(tmp_path),
                         ckpt_every=5, log_every=100)
    seen = []

    def spy(p, o, b):
        if not seen:
            seen.append({n: t.detach().clone()
                         for n, t in p.named_parameters()})
            seen.append(int(o["step"]))
        return step(p, o, b)
    r2 = train_loop(dcfg2, spy, model2, opt2, get_batch, log=lambda s: None)
    assert r2.resumed_from == 10
    assert len(r2.losses) == 2
    assert seen[1] == 10
    for n, t in saved.items():
        assert torch.equal(seen[0][n], t), n


def test_driver_counts_non_finite_steps(tmp_path):
    """A non-finite loss is counted and the run carries on from the step's
    output (the JAX code's behaviour); past max_nan_skips it raises."""
    calls = []

    def step(p, o, b):
        calls.append(b)
        loss = math.nan if b % 2 else 1.0
        return p, o, {"loss": torch.tensor(loss)}
    params = {"w": torch.zeros(3)}
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    dcfg = DriverConfig(total_steps=6, ckpt_dir=str(tmp_path / "a"),
                        ckpt_every=100, log_every=100, max_nan_skips=3)
    r = train_loop(dcfg, step, params, opt, lambda i: i, log=lambda s: None)
    assert r.nan_skips == 3 and r.losses == [1.0, 1.0, 1.0]
    dcfg = dataclasses.replace(dcfg, ckpt_dir=str(tmp_path / "b"),
                               max_nan_skips=2)
    with pytest.raises(RuntimeError, match="non-finite"):
        train_loop(dcfg, step, params, opt, lambda i: i, log=lambda s: None)
