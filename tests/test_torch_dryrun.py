"""The meta-device dry run (``repro_torch.launch.dryrun``, ``report``,
``specs``, ``roofline``).

* ``dryrun.main(["--all"])`` plans every (arch x shape) cell of the
  production 16 x 16 mesh on ``meta``: each is ``ok`` or one of
  ``runnable``'s skips (the JAX package's: ``long_500k`` on a pure
  full-attention arch), and ``report`` renders each.  The whole run over
  the ten archs at full width grows the process's peak RSS by under 1 GiB.
* The dry run's per-rank bytes of parameters, moments and cache equal the
  bytes the sharded steps place on every rank of a (2, 4) mesh, on smoke
  configs.
* ``specs``' stand-ins have the JAX package's shapes (``eval_shape``).
* The roofline's three terms and its H100 constants.

The JAX dry run is never imported: it forces 512 host devices at import.
"""

import dataclasses
import json
import math
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.launch import dryrun, report, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import make_pod_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import steps as rt  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402


def test_dry_run_plans_every_cell_on_meta_within_a_gib(tmp_path, capsys):
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out = tmp_path / "dry.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown < 1024 * 1024, f"peak RSS grew {grown} KiB"
    results = json.loads(out.read_text())
    assert set(results) == {f"single/{a}/{s}" for a in ARCH_IDS
                            for s in SHAPES}
    for key, res in results.items():
        _, arch, shape = key.split("/")
        skip = dryrun.runnable(get_config(arch), SHAPES[shape])
        if skip:
            assert res == {"status": "skipped", "reason": skip}
            assert shape == "long_500k"
            continue
        assert res["status"] == "ok", key
        assert res["mesh_shape"] == [16, 16]
        r = res["roofline"]
        assert r["chips"] == 256 and r["bottleneck"] in (
            "compute", "memory", "collective")
        assert res["fits"] == (r["memory_stats"]["peak_bytes"] <= 80e9)
        assert r["memory_stats"]["hbm_bytes"] == roofline.HBM_BYTES
    n_skip = sum(v["status"] == "skipped" for v in results.values())
    assert n_skip == sum(not get_config(a).sub_quadratic for a in ARCH_IDS)
    printed = capsys.readouterr().out
    lines = report.table(results, "single")
    assert len(lines) == 2 + len(results)
    for line in lines:
        assert line in printed
    # a second run keeps the cached cells
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == results


def test_llama_train_4k_state_on_the_production_mesh():
    """llama3.2-3b at train_4k: TP over 16 model ranks, replicated over 16
    data ranks (no FSDP), so a rank holds 1/16 of every sharded leaf."""
    res = dryrun.lower_cell("llama3.2-3b", "train_4k")
    cfg = get_config("llama3.2-3b")
    model = specs.params_shape(get_model(cfg))
    mesh = make_pod_mesh((16, 16), "meta")
    pspec = rules.param_specs(cfg, model, mesh)
    want = sum(p.numel() * p.element_size() // math.prod(
        rules.parts(pspec[n], mesh)) for n, p in model.named_parameters())
    assert res["per_rank"]["param_bytes"] == want
    assert res["per_rank"]["moment_bytes"] == 2 * want   # fp32 params
    assert res["fits"]


@pytest.mark.parametrize("arch,changes", [
    ("llama3.2-3b", {}), ("internlm2-20b", {"fsdp_params": True}),
    ("qwen2-moe-a2.7b", {}), ("recurrentgemma-2b", {})])
def test_dry_run_bytes_equal_what_the_sharded_steps_place(arch, changes):
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    api = get_model(cfg)
    mesh = make_pod_mesh((2, 4), "cpu")
    train, decode = (ShapeConfig("t", 32, 8, "train"),
                     ShapeConfig("d", 16, 4, "decode"))
    plan_t = dryrun.plan_cell(cfg, train, make_pod_mesh((2, 4), "meta"))
    plan_d = dryrun.plan_cell(cfg, decode, make_pod_mesh((2, 4), "meta"))
    model = api.init(torch.Generator().manual_seed(0))
    oc = adamw.OptConfig(moment_dtype=cfg.opt_dtype)
    _, pspec, _, _ = rt.shard_train_step(api, cfg, oc, mesh, train, model,
                                         specs.batch_specs(cfg, train))
    params = rt.shard_params(model, pspec, mesh)
    opt = adamw.init_sharded(oc, params)
    cache = api.init_cache(4, 16, device="cpu")
    _, _, cspec = rt.shard_serve_step(api, cfg, mesh, decode, model, cache)
    sc = rules.shard_tree(cache, cspec, mesh)
    for r in rules.ranks(mesh):
        assert rules.rank_bytes(params, *r) == plan_t["per_rank"][
            "param_bytes"] == plan_d["per_rank"]["param_bytes"]
        moments = rules.rank_bytes({"m": opt["m"], "v": opt["v"]}, *r)
        assert moments == plan_t["per_rank"]["moment_bytes"]
        assert rules.rank_bytes(sc, *r) == plan_d["per_rank"]["cache_bytes"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_shapes_match_jax(arch):
    """The stand-ins' shapes and dtypes against the JAX package's: the
    batch, the decode inputs, the decode cache (batch 2, length 64: the
    shapes of ``decode_32k``'s layout) and the parameter count."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    jshape = dataclasses.replace(JSHAPES["decode_32k"], seq_len=64,
                                 global_batch=2)
    api, japi = get_model(cfg), jget_model(jcfg)
    cache = specs.cache_shape(api, cfg, shape)
    jcache = jspecs.cache_shape(japi, jcfg, jshape)
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, want in flat:
        got = cache
        for key in path:
            got = got[key.key]
        assert got.is_meta and tuple(got.shape) == tuple(want.shape), path
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    for mine, theirs in zip(specs.decode_inputs(cfg, shape),
                            jspecs.decode_inputs(jcfg, jshape)):
        assert tuple(mine.shape) == tuple(theirs.shape)
    jp = jspecs.params_shape(japi)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    model = specs.params_shape(api)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert all(p.is_meta for p in model.parameters())


def test_roofline_terms_and_constants():
    r = roofline.analyze(chips=8, kind="train", n_active_params=1e9,
                         global_batch=4, seq_len=2048, bytes_per_chip=3.35e12,
                         collectives={"all-gather": 450e9, "all-reduce": 0.0},
                         memory_stats={}, recompute=4 / 3,
                         computing_chips=2)
    mf = roofline.model_flops("train", 1e9, 4, 2048)
    assert mf == jroofline.model_flops("train", 1e9, 4, 2048)
    assert r.flops_per_chip == pytest.approx(mf * 4 / 3 / 2)
    assert r.t_compute == pytest.approx(r.flops_per_chip / 989e12)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.bottleneck in ("memory", "collective")
    assert r.useful_flops_ratio == pytest.approx(mf / (r.flops_per_chip * 8))
    assert r.mfu_bound == pytest.approx(mf / 8 / r.t_bound / 989e12)
    d = r.to_dict()
    assert d["memory_stats"]["hbm_bytes"] == 80e9
    assert roofline.NVLINK_BYTES_PER_S == 450e9
