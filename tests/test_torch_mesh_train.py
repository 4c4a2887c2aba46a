"""Training and serving on a data x model mesh of ``cpu`` ranks, against the
unsharded steps of the port and of the JAX package.

* ``shard_train_step`` on a (2, 4) mesh against the port's
  ``make_train_step`` on the same weights and batch: loss rtol 1e-5,
  every updated parameter and AdamW moment rtol 1e-5 atol 1e-6, each
  rank's blocks equal to their slices of the gathered tensor; a dense
  config, an MoE config whose micro-batches sit on both data ranks (its
  aux loss included; it differs without the batch's routing counts) and
  an ``fsdp_params`` one.  The same step against the JAX package's
  unsharded ``make_train_step`` on ``lm_params_from_numpy`` weights: loss
  within 1e-3 (``tests/test_spmd.py:85``).
* ``shard_serve_step`` against ``make_serve_step``: logits rtol 1e-5 atol
  1e-5 over 8 decode steps, signatures equal, every cache leaf allclose
  and each rank's cache block its slice; a cache length split over the
  model ranks, a length that does not divide (replicated), and the
  recurrent families' caches.  The same step against the JAX package's
  ``make_serve_step`` on ``lm_params_from_numpy`` weights and converted
  ``LshServeParams``: logits rtol 1e-4 atol 1e-5 (as
  ``tests/test_torch_lm_serve.py``), signatures equal on rows whose W2
  embeddings are equal, except where the JAX projection lies within 1e-5
  of an integer.
* ``optim.compress``: codes and scales bit-equal to the JAX package's
  jitted ``ef_compress``; ``compressed_psum`` equal to the mean of the
  ranks' dequantized payloads and within 2% of the true mean
  (``tests/test_spmd.py:92``); error feedback tracks the true sum
  (``tests/test_train.py:117``).
* ``checkpoint.restore`` onto another mesh: saved from (2, 4), restored
  onto (4, 2), every block on its new rank and bit-equal.
* ``data.pipeline``: the per-host slices bit-equal to the JAX package's,
  the prefetched stream equal to ``get_batch``, the thread stopped and
  joined.
* ``launch.train.main(["--mesh-devices", "8", ...])`` on ``cpu`` and a
  resume; the driver's ``put_batch`` and ``on_straggler`` hooks.

No test here spawns a process, arms a fault plan or leaves a thread or the
ambient mesh behind.
"""

import dataclasses
import threading

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
from repro.optim import compress as jcompress  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.launch.mesh import make_pod_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.runtime import steps as rt  # noqa: E402
from repro_torch.runtime.driver import DriverConfig, train_loop  # noqa: E402
from repro_torch.sharding import context, rules  # noqa: E402

B, S = 8, 32

# (arch, config changes): dense, MoE (both data ranks hold rows of each
# micro-batch), FSDP over the data axis
CONFIGS = {"dense": ("llama3.2-3b", {}),
           "moe": ("qwen2-moe-a2.7b", {}),
           "fsdp": ("internlm2-20b", {"fsdp_params": True})}


@pytest.fixture(autouse=True)
def _hygiene():
    """The ambient mesh as it was, and no thread left running.  The steps
    run thousands of small ops: with one intra-op thread they do not wait
    on a thread pool that other test processes crowd out (the suite runs
    six at once); the setting is put back after each test."""
    mesh, threads = context.get_mesh(), threading.active_count()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n_threads)
    assert context.get_mesh() is mesh
    assert threading.active_count() <= threads


def _cfg(kind, n_layers=1):
    arch, changes = CONFIGS[kind]
    return dataclasses.replace(configs.smoke_config(arch), n_layers=n_layers,
                               grad_accum=2, **changes)


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _sharded_step(cfg, model, mesh, oc):
    api = get_model(cfg)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    step, pspec, ospec, bspec = rt.shard_train_step(
        api, cfg, oc, mesh, ShapeConfig("t", S, B, "train"), model, batch)
    params = rt.shard_params(model, pspec, mesh)
    return step, params, adamw.init_sharded(oc, params), (pspec, ospec,
                                                           bspec)


def _assert_blocks_are_slices(s):
    full = rules.gather(s)
    for r in s.ranks():
        assert torch.equal(s.block(*r), full[s.slices(*r)]), r
    return full


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_sharded_train_step_matches_the_unsharded_step(kind):
    """Two steps on a (2, 4) mesh against two of ``make_train_step``, at
    the JAX test's ``OptConfig()``."""
    cfg = _cfg(kind)
    api = get_model(cfg)
    oc = adamw.OptConfig()
    m1 = api.init(torch.Generator().manual_seed(0))
    m2 = api.init(torch.Generator().manual_seed(0))
    step1 = rt.make_train_step(api, cfg, oc)
    o1 = adamw.init(oc, dict(m1.named_parameters()))
    mesh = make_pod_mesh((2, 4), device="cpu")
    step, params, opt, (pspec, ospec, bspec) = _sharded_step(cfg, m2, mesh,
                                                             oc)
    assert bspec == {"tokens": ("data", None)}
    assert ospec == {"m": pspec, "v": pspec, "step": ()}
    if kind == "fsdp":
        assert pspec["layers.0.attn.wq"] == ("data", "model", None)
    for i in range(2):
        batch = {"tokens": torch.as_tensor(_tokens(cfg, seed=i))}
        _, o1, want = step1(m1, o1, batch)
        params, opt, got = step(params, opt, batch)
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    if kind == "moe":
        assert float(got["aux"]) > 0
    named = dict(m1.named_parameters())
    for n, s in params.items():
        torch.testing.assert_close(_assert_blocks_are_slices(s),
                                   named[n].detach(), rtol=1e-5, atol=1e-6)
        for key in ("m", "v"):
            torch.testing.assert_close(
                _assert_blocks_are_slices(opt[key][n]), o1[key][n],
                rtol=1e-5, atol=1e-6)
    assert all(int(opt["step"].block(*r)) == 2 for r in rules.ranks(mesh))


def test_moe_aux_needs_the_batch_routing(monkeypatch):
    """Summing the data ranks' own Switch aux terms is not the batch's aux:
    with each rank's routing counts in place of the batch's, the sharded
    step's aux moves off the unsharded one's."""
    cfg = _cfg("moe")
    api = get_model(cfg)
    oc = adamw.OptConfig()
    batch = {"tokens": torch.as_tensor(_tokens(cfg))}
    m1 = api.init(torch.Generator().manual_seed(0))
    _, _, want = rt.make_train_step(api, cfg, oc)(
        m1, adamw.init(oc, dict(m1.named_parameters())), batch)
    monkeypatch.setattr(moe.GlobalRouting, "apply", moe.GlobalRouting.record)
    m2 = api.init(torch.Generator().manual_seed(0))
    step, params, opt, _ = _sharded_step(cfg, m2, make_pod_mesh(
        (2, 4), device="cpu"), oc)
    _, _, got = step(params, opt, batch)
    assert abs(float(got["aux"]) - float(want["aux"])) > 1e-4


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_sharded_train_step_matches_jax(kind):
    """The sharded step's loss against the JAX package's unsharded
    ``make_train_step`` on the same weights (``tests/test_spmd.py:85``'s
    1e-3)."""
    arch, changes = CONFIGS[kind]
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), n_layers=2,
                               grad_accum=2, **changes)
    japi = jget_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    joc = jadamw.OptConfig()
    toks = _tokens(jcfg)
    _, _, jm = jax.jit(jsteps.make_train_step(japi, jcfg, joc))(
        params, jadamw.init(joc, params), {"tokens": jnp.asarray(toks)})
    cfg = _cfg(kind, n_layers=2)
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    step, sp, opt, _ = _sharded_step(cfg, model, make_pod_mesh(
        (2, 4), device="cpu"), adamw.OptConfig())
    _, _, m = step(sp, opt, {"tokens": torch.as_tensor(toks)})
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-3
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)


def _leaves(tree, pre=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{pre}{k}.")
        else:
            yield pre + k, tree[k]


@pytest.mark.parametrize("arch,b,t,mesh_shape", [
    ("llama3.2-3b", 8, 16, (2, 4)),          # cache length over model
    ("qwen2-moe-a2.7b", 4, 12, (2, 4)),      # 12 % 4: length over model
    ("glm4-9b", 3, 10, (2, 4)),              # batch and length replicated
    ("mamba2-2.7b", 4, 8, (2, 4)),           # conv and SSM states
    ("recurrentgemma-2b", 4, 8, (4, 2)),     # ring buffers
])
def test_sharded_serve_step_matches_the_serve_step(arch, b, t, mesh_shape):
    cfg = configs.smoke_config(arch)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    lsh = rt.LshServeParams.create(torch.Generator().manual_seed(1), cfg)
    serve = rt.make_serve_step(api, cfg, lsh)
    cache = api.init_cache(b, t, device="cpu")
    mesh = make_pod_mesh(mesh_shape, device="cpu")
    step, pspec, cspec = rt.shard_serve_step(
        api, cfg, mesh, ShapeConfig("d", t, b, "decode"), model, cache, lsh)
    params = rt.shard_params(model, pspec, mesh)
    sc = rules.shard_tree(cache, cspec, mesh)
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, 1)), dtype=torch.int32)
    for pos in range(min(t, 8)):
        want, cache = serve(model, cache, tok, pos)
        got, sc = step(params, sc, tok, pos)
        torch.testing.assert_close(got["logits"], want["logits"], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(got["next"], want["next"])
        assert torch.equal(got["lsh_sig"], want["lsh_sig"])
        tok = want["next"]
    for (name, full), (_, s) in zip(_leaves(cache), _leaves(sc)):
        torch.testing.assert_close(_assert_blocks_are_slices(s), full,
                                   rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b"])
def test_sharded_serve_step_matches_jax(arch):
    """8 greedy decode steps of the sharded serve step on a (2, 4) mesh
    against the JAX package's unsharded ``make_serve_step`` on the same
    weights and hashing state."""
    from repro.core import wasserstein as jwass
    from repro_torch.core import wasserstein
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    japi, api = jget_model(jcfg), get_model(cfg)
    params = japi.init(jax.random.PRNGKey(0))
    model = api.init(torch.Generator().manual_seed(0))
    convert.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    jlsh = jsteps.LshServeParams.create(jax.random.PRNGKey(1), jcfg)
    lsh = convert.lsh_serve_params_from_numpy(
        *(np.asarray(t) for t in (jlsh.nodes, jlsh.volume, jlsh.support,
                                  jlsh.alpha, jlsh.b)), jlsh.r, device="cpu")
    jserve = jax.jit(jsteps.make_serve_step(japi, jcfg, jlsh))
    b, t = 4, 8
    jcache = japi.init_cache(b, t)
    cache = api.init_cache(b, t, device="cpu")
    mesh = make_pod_mesh((2, 4), device="cpu")
    step, pspec, cspec = rt.shard_serve_step(
        api, cfg, mesh, ShapeConfig("d", t, b, "decode"), model, cache, lsh)
    sp = rt.shard_params(model, pspec, mesh)
    sc = rules.shard_tree(cache, cspec, mesh)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, 1)).astype(np.int32)
    compared = 0
    for pos in range(t):
        jout, jcache = jserve(params, jcache, jnp.asarray(toks),
                              jnp.int32(pos))
        out, sc = step(sp, sc, torch.tensor(toks), pos)
        jl = np.asarray(jout["logits"])
        np.testing.assert_allclose(out["logits"].numpy(), jl, rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {pos}")
        emb = wasserstein.w2_embedding_logits(
            out["logits"][:, 0, :], lsh.support, lsh.nodes, lsh.volume)
        jemb = np.asarray(jwass.w2_embedding_logits(
            jout["logits"][:, 0, :], jlsh.support, jlsh.nodes, jlsh.volume))
        same = (emb.numpy() == jemb).all(axis=1)
        proj = np.asarray(jemb @ jlsh.alpha / jlsh.r + jlsh.b)
        near = np.abs(proj - np.round(proj)) <= 1e-5
        apart = (out["lsh_sig"].numpy() != np.asarray(jout["lsh_sig"])) & ~near
        assert not apart[same].any(), f"step {pos}"
        compared += int(same.sum())
        toks = np.asarray(jout["next"]).reshape(b, 1)
    assert compared >= b * t - b * t // 16, compared


# -- int8 error-feedback compression ------------------------------------------


def test_ef_compress_codes_and_scales_bit_equal_jax():
    """Against the JAX package's ``ef_compress`` jitted, as it runs inside
    ``compressed_psum`` (eager JAX divides by 127 where XLA multiplies)."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((64, 32)).astype(np.float32) * 1e-3,
             "b": {"c": rng.standard_normal((7,)).astype(np.float32) * 5.0,
                   "z": np.zeros((3, 3), np.float32)}}
    errs = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-4)
                        .astype(np.float32), grads)
    jq, js, je = jax.jit(jcompress.ef_compress)(grads, errs)
    as_t = lambda t: jax.tree.map(torch.as_tensor, t)  # noqa: E731
    q, s, e = compress.ef_compress(as_t(grads), as_t(errs))
    for path, want in jax.tree_util.tree_flatten_with_path(jq)[0]:
        got = q
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(js)[0],
                                 jax.tree.leaves(jax.tree.map(
                                     lambda t: t.numpy(), s))):
        assert np.asarray(want).tobytes() == np.float32(got).tobytes(), path
    # the residual (g + e) - q * scale: XLA fuses it into one multiply-add,
    # so the two differ by the rounding of q * scale (an ulp of max|g + e|)
    for want, got, g, err in zip(
            jax.tree.leaves(je),
            jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), e)),
            jax.tree.leaves(grads), jax.tree.leaves(errs)):
        ulp = float(np.spacing(np.abs(g + err).max()))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ulp)


def test_compressed_psum_is_the_mean_of_the_dequantized_payloads():
    """Eight ranks of one axis (``tests/test_spmd.py:92``'s shapes): each
    rank's mean is the mean of every rank's dequantized int8 payload, and
    within 2% of the true mean."""
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, 64)).astype(np.float32) * 1e-3)
    grads = [{"g": g[i:i + 1]} for i in range(8)]
    errs = [compress.ef_init(t) for t in grads]
    means, new_err = compress.compressed_psum(grads, errs)
    deq = [compress.dequantize_int8(*compress.quantize_int8(t["g"]))
           for t in grads]
    want = torch.stack(deq).sum(dim=0) / 8
    for m in means:
        assert torch.equal(m["g"], want)
    true_mean = g.mean(dim=0, keepdim=True)
    rel = float((means[0]["g"] - true_mean).abs().max()
                / (true_mean.abs().max() + 1e-12))
    assert rel < 0.02
    for t, d, e in zip(grads, deq, new_err):
        assert torch.equal(e["g"], t["g"] - d)


def test_error_feedback_tracks_the_true_sum():
    """``tests/test_train.py:117``: the cumulative sent sum tracks the true
    one within the last residual."""
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, 64)) * 1e-3, dtype=torch.float32)
    err = torch.zeros_like(g)
    total_true = torch.zeros_like(g)
    total_sent = torch.zeros_like(g)
    for i in range(20):
        q, s, e = compress.ef_compress({"g": g * (i + 1)}, {"g": err})
        total_sent += compress.dequantize_int8(q["g"], s["g"])
        total_true += g * (i + 1)
        err = e["g"]
    resid = float((total_true - total_sent).abs().max())
    assert resid <= float((g * 20).abs().max()) / 127 * 1.5


# -- elastic restore, the pipeline, the launcher -------------------------------


def test_restore_onto_another_mesh_is_bit_equal(tmp_path):
    """``tests/test_spmd.py:118``: saved from (2, 4) over ("data",
    "model"), restored onto (4, 2) over ("model", "data"); and a model's
    sharded parameters saved whole and re-laid out by their specs."""
    m1 = make_pod_mesh((2, 4), device="cpu")
    m2 = make_pod_mesh((4, 2), device="cpu")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    cfg = _cfg("fsdp")
    model = get_model(cfg).init(torch.Generator().manual_seed(3))
    pspec1 = rules.param_specs(cfg, model, m1)
    tree = {"x": rules.shard(x, ("data", "model"), m1),
            "params": rt.shard_params(model, pspec1, m1)}
    ckpt.save(str(tmp_path), 1, tree)
    target = {"x": ckpt.ArraySpec((8, 8), torch.float32),
              "params": {n: ckpt.ArraySpec(tuple(p.shape), p.dtype)
                         for n, p in model.named_parameters()}}
    pspec2 = rules.param_specs(cfg, model, m2)
    shardings = {"x": rules.NamedSpec(m2, ("model", "data")),
                 "params": rules.named(m2, pspec2)}
    back = ckpt.restore(str(tmp_path), 1, target, shardings=shardings)
    assert back["x"].spec == ("model", "data") and back["x"].mesh is m2
    assert torch.equal(_assert_blocks_are_slices(back["x"]), x)
    for n, p in model.named_parameters():
        s = back["params"][n]
        assert s.mesh is m2 and s.spec == pspec2[n]
        assert torch.equal(_assert_blocks_are_slices(s), p.detach())


@pytest.mark.parametrize("pcount", [1, 2, 4])
def test_pipeline_host_slices_match_jax(pcount):
    jcfg = jconfigs.smoke_config("seamless-m4t-medium")   # frames too
    cfg = configs.smoke_config("seamless-m4t-medium")
    for pidx in range(pcount):
        jp = jpipeline.SyntheticPipeline(
            jcfg, JShapeConfig("t", 16, 8, "train"), seed=5,
            process_index=pidx, process_count=pcount)
        p = SyntheticPipeline(cfg, ShapeConfig("t", 16, 8, "train"), seed=5,
                              process_index=pidx, process_count=pcount)
        assert p.local_batch == jp.local_batch == 8 // pcount
        for step in (0, 7):
            want, got = jp.get_batch(step), p.get_batch(step)
            assert set(want) == set(got)
            for k in want:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetched_stream_equals_get_batch_and_the_thread_stops():
    cfg = configs.smoke_config("llama3.2-3b")
    p = SyntheticPipeline(cfg, ShapeConfig("t", 16, 4, "train"), seed=2,
                          prefetch=2)
    with p.start(first_step=3):
        it = iter(p)
        for step in range(3, 9):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          p.get_batch(step)["tokens"])
        worker = p._thread
        assert worker.is_alive()
    assert not worker.is_alive()
    assert list(iter(p)) == []         # closed: the stream ends


@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-medium",
                                  "qwen2-vl-2b"])   # tokens, frames, patches
def test_launcher_trains_on_a_mesh_and_resumes(tmp_path, arch):
    from repro_torch.launch import train
    args = ["--arch", arch, "--device", "cpu", "--mesh-devices", "8",
            "--seq-len", "16", "--batch", "8", "--ckpt", str(tmp_path)]
    r1 = train.main(args + ["--steps", "2"])
    assert r1.final_step == 2 and r1.resumed_from is None
    assert np.isfinite(r1.losses).all() and len(r1.losses) == 2
    r2 = train.main(args + ["--steps", "3"])
    assert r2.resumed_from == 2 and len(r2.losses) == 1
    # the mesh's checkpoint holds whole arrays: the unsharded launcher
    # resumes from it too
    r3 = train.main(["--arch", arch, "--device", "cpu", "--seq-len", "16",
                     "--batch", "8", "--ckpt", str(tmp_path), "--steps", "4"])
    assert r3.resumed_from == 3 and len(r3.losses) == 1


def test_driver_hooks_put_batch_and_on_straggler(tmp_path):
    cfg = dataclasses.replace(configs.smoke_config("llama3.2-3b"),
                              n_layers=1)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    oc = adamw.OptConfig(total_steps=3)
    opt = adamw.init(oc, dict(model.named_parameters()))
    step = rt.make_train_step(api, cfg, oc)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", 16, 2, "train"))
    put, slow = [], []

    def put_batch(b):
        put.append(b)
        return {k: torch.as_tensor(v) for k, v in b.items()}
    r = train_loop(DriverConfig(total_steps=3, ckpt_dir=str(tmp_path),
                                deadline_s=0.0),
                   step, model, opt, pipe.get_batch, put_batch=put_batch,
                   on_straggler=lambda s, dt: slow.append((s, dt)),
                   log=lambda s: None)
    assert len(put) == 3 and isinstance(put[0]["tokens"], np.ndarray)
    assert [s for s, _ in slow] == [0, 1, 2] and r.straggler_events == 3
    assert all(dt > 0 for _, dt in slow)
