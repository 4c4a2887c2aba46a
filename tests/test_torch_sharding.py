"""The port's sharding rules (``repro_torch.sharding.rules``) against the JAX
package's (``repro.sharding.rules``), and its blocks over a mesh of ranks.

* ``param_specs`` on the ten archs x both mesh shapes of
  ``tests/test_sharding.py`` (a duck-typed mesh with the production axis
  sizes; the JAX side's params from ``eval_shape``), equal entry for entry
  to the JAX package's once its stacked leaves' leading ``None`` is
  dropped; every sharded dim divides its axes; the FSDP toggle, the batch
  fallback and SP on the cache length, as that file checks them; the
  batch and cache specs of every arch equal the JAX package's.
* ``shard`` / ``gather`` / ``scatter`` over ``cpu`` ranks: every block is
  its slice, the gathered tensor bit-equal; a replicated dim gives every
  rank its own copy.
* ``sharding.context``: ``use_mesh`` puts the ambient mesh back,
  ``constrain`` returns its input, and the MoE layer's three constraint
  points change no value.
* ``dispatch.resolve_device`` names every device it accepts, and a model
  and cache built on ``meta`` allocate nothing.

Every test leaves the ambient mesh as it found it.
"""

import dataclasses
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.convert import _lm_path  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_pod_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.sharding import context, rules  # noqa: E402


class _FakeMesh:
    """Duck-typed mesh with production axis sizes (``tests/test_sharding.py``)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def _ambient_mesh_restored():
    before = context.get_mesh()
    yield
    assert context.get_mesh() is before
    context.set_mesh(before)


def _jax_leaf(tree, name):
    path, layer = _lm_path(name)
    leaf = tree
    for key in path:
        leaf = leaf[key]
    return leaf, layer


def _jax_spec(spec_tree, name):
    spec, layer = _jax_leaf(spec_tree, name)
    spec = tuple(spec)
    return spec[1:] if layer is not None else spec


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("multi", [False, True])
def test_param_specs_match_jax_on_the_production_mesh(arch, multi):
    """Every parameter's spec equals the JAX rules' for it, and each
    sharded dim divides its axes' product (the JAX file's contract)."""
    mesh = _FakeMesh(MESHES["multi" if multi else "single"])
    jcfg = jget_config(arch)
    jp = jspecs.params_shape(jget_model(jcfg))
    jspec = jrules.param_specs(jcfg, jp, mesh)
    cfg = get_config(arch)
    model = specs.params_shape(get_model(cfg))
    spec = rules.param_specs(cfg, model, mesh)
    named = dict(model.named_parameters())
    assert set(spec) == set(named)
    for name, p in named.items():
        assert spec[name] == _jax_spec(jspec, name), name
        leaf, layer = _jax_leaf(jp, name)
        want = leaf.shape[1:] if layer is not None else leaf.shape
        assert tuple(p.shape) == tuple(want), name
        for dim, ax in zip(p.shape, spec[name]):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            size = int(np.prod([mesh.shape[a] for a in axes]))
            assert dim % size == 0, (name, p.shape, spec[name])


def test_fsdp_toggles_data_axis():
    cfg = get_config("internlm2-20b")           # fsdp_params=True
    model = specs.params_shape(get_model(cfg))
    mesh = _FakeMesh(MESHES["single"])
    spec = rules.param_specs(cfg, model, mesh)
    assert spec["layers.0.attn.wq"] == ("data", "model", None)
    cfg2 = dataclasses.replace(cfg, fsdp_params=False)
    spec2 = rules.param_specs(cfg2, model, mesh)
    assert "data" not in str(spec2["layers.0.attn.wq"])
    jcfg2 = dataclasses.replace(jget_config("internlm2-20b"),
                                fsdp_params=False)
    jspec2 = jrules.param_specs(
        jcfg2, jspecs.params_shape(jget_model(jcfg2)), mesh)
    for name in spec2:
        assert spec2[name] == _jax_spec(jspec2, name), name


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("batch", [256, 32, 16, 8, 1])
def test_batch_axis_fallback(mesh_name, batch):
    mesh = _FakeMesh(MESHES[mesh_name])
    assert rules.batch_axis(mesh, batch) == jrules.batch_axis(mesh, batch)
    assert rules.dp_axes(mesh) == jrules.dp_axes(mesh)
    if mesh_name == "multi":
        want = {256: ("pod", "data"), 32: ("pod", "data"), 16: ("pod",),
                8: ("pod",), 1: None}[batch]
        assert rules.batch_axis(mesh, batch) == want


def test_cache_specs_sequence_parallel():
    cfg = get_config("glm4-9b")                 # kv=2 < 16 -> SP on length
    api = get_model(cfg)
    c_shape = specs.cache_shape(api, cfg, SHAPES["decode_32k"])
    mesh = _FakeMesh(MESHES["single"])
    spec = rules.cache_specs(cfg, c_shape, mesh, 128)
    assert spec["k"][2] == "model"              # (L, B, T@model, KV, D)
    assert spec["k"][1] is not None             # batch sharded


def _jax_cache_specs(arch, shape, mesh):
    jcfg = jget_config(arch)
    japi = jget_model(jcfg)
    c = jspecs.cache_shape(japi, jcfg, JSHAPES[shape])
    return jax.tree.map(
        tuple, jrules.cache_specs(jcfg, c, mesh, JSHAPES[shape].global_batch),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_jax(arch):
    """Cache specs at decode_32k on both mesh shapes, and at long_500k
    (batch 1: nothing over data) on the single one; the training batch's
    specs (frames and patches included) at train_4k and batch 1."""
    cfg = get_config(arch)
    api = get_model(cfg)
    shapes = ["decode_32k"] + (["long_500k"] if cfg.sub_quadratic else [])
    for mesh_name in ("single", "multi"):
        mesh = _FakeMesh(MESHES[mesh_name])
        for sname in shapes:
            if mesh_name == "multi" and sname == "long_500k":
                continue
            c = specs.cache_shape(api, cfg, SHAPES[sname])
            got = rules.cache_specs(cfg, c, mesh, SHAPES[sname].global_batch)
            assert got == _jax_cache_specs(arch, sname, mesh), (mesh_name,
                                                                 sname)
        for gb in (SHAPES["train_4k"].global_batch, 1):
            shape = dataclasses.replace(SHAPES["train_4k"], global_batch=gb)
            b = specs.batch_specs(cfg, shape)
            jb = jspecs.batch_specs(jget_config(arch), dataclasses.replace(
                JSHAPES["train_4k"], global_batch=gb))
            assert {k: tuple(v.shape) for k, v in b.items()} == {
                k: tuple(v.shape) for k, v in jb.items()}
            want = jax.tree.map(tuple, jrules.batch_specs(
                jget_config(arch), jb, mesh, gb),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert rules.batch_specs(cfg, b, mesh, gb) == want


# -- blocks over a mesh of ranks ---------------------------------------------


@pytest.mark.parametrize("spec", [("data", "model"), ("model", "data"),
                                  (None, "model"), ("data", None),
                                  (("data", "model"), None), (None, None)])
def test_shard_places_each_block_and_gather_is_bit_equal(spec):
    mesh = make_pod_mesh((2, 4), device="cpu")
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    s = rules.shard(x, spec, mesh)
    seen = set()
    for di, mi in rules.ranks(mesh):
        blk = s.block(di, mi)
        assert torch.equal(blk, x[s.slices(di, mi)])
        assert tuple(blk.shape) == rules.block_shape((8, 16), spec, mesh)
        assert blk.untyped_storage().data_ptr() not in seen  # its own copy
        seen.add(blk.untyped_storage().data_ptr())
    assert torch.equal(rules.gather(s), x)
    owners = sum(rules.is_owner(s.spec, mesh, *r) for r in rules.ranks(mesh))
    assert owners == int(np.prod(rules.parts(s.spec, mesh)))


def test_shard_refuses_uneven_dims():
    mesh = make_pod_mesh((2, 4), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        rules.shard(torch.zeros(6, 8), ("model", None), mesh)


@pytest.mark.parametrize("spec", [(None, "data", "model", None),
                                  (None, None, "model", None),
                                  (None, "data", None, None)])
def test_scatter_writes_every_block_its_slice(spec):
    """The decode cache's write-back: a whole (L, B, T, ...) tensor's
    slices copied into blocks split over data and model, replicas
    included; ``gather_tree`` reads the tree back bit-equal."""
    mesh = make_pod_mesh((2, 4), device="cpu")
    s = rules.shard(torch.zeros(3, 4, 16, 2), spec, mesh)
    full = torch.randn(3, 4, 16, 2, generator=torch.Generator().manual_seed(1))
    rules.scatter(full, s)
    for r in rules.ranks(mesh):
        assert torch.equal(s.block(*r), full[s.slices(*r)]), r
    back = rules.gather_tree({"k": s, "pos": 3})
    assert torch.equal(back["k"], full) and back["pos"] == 3


def test_named_pairs_each_spec_with_its_mesh():
    mesh = make_pod_mesh((2, 2), device="cpu")
    tree = rules.named(mesh, {"a": ("data", None), "b": {"c": ()}})
    assert tree["a"] == rules.NamedSpec(mesh, ("data", None))
    assert tree["b"]["c"].spec == ()


# -- the ambient mesh and constrain -------------------------------------------


def test_use_mesh_restores_and_constrain_returns_its_input():
    mesh = make_pod_mesh((2, 4), device="cpu")
    x = torch.randn(2, 3, 4, 5)
    assert context.get_mesh() is None
    with context.use_mesh(mesh):
        assert context.get_mesh() is mesh
        assert context.constrain(x, (context.UNCONSTRAINED, "model", None,
                                     None)) is x
        with pytest.raises(ValueError):
            context.constrain(x, ("model",))
    assert context.get_mesh() is None
    assert context.constrain(x, ("model",)) is x     # no mesh: no check


def test_moe_constraint_points_change_no_value():
    cfg = smoke_config("qwen2-moe-a2.7b")
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    p = model.layers[0].moe
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        want, waux = moe.moe_ffn(p, cfg, x)
        with context.use_mesh(make_pod_mesh((2, 4), device="cpu")):
            got, gaux = moe.moe_ffn(p, cfg, x)
    assert torch.equal(got, want) and torch.equal(gaux, waux)


# -- devices -----------------------------------------------------------------


def test_resolve_device_names_every_device_it_accepts():
    assert dispatch.resolve_device("meta") == torch.device("meta")
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError) as e:
        dispatch.resolve_device("xpu")
    for name in ("'cuda'", "'cpu'", "'meta'"):
        assert name in str(e.value)
    doc = dispatch.resolve_device.__doc__
    assert all(n in doc for n in ('"cpu"', '"meta"', "card"))


def test_meta_allocates_nothing():
    """arctic-480b (~1.9 TB of fp32 weights) and its decode_32k cache on
    ``meta``: every tensor on meta, the process's peak RSS grown by well
    under a GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cfg = get_config("arctic-480b")
    api = get_model(cfg)
    model = specs.params_shape(api)
    cache = specs.cache_shape(api, cfg, SHAPES["decode_32k"])
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    n = sum(p.numel() for p in model.parameters())
    assert n > 4e11
    assert all(p.device.type == "meta" for p in model.parameters())
    assert all(t.device.type == "meta" for t in cache.values())
    assert grown < 256 * 1024, f"peak RSS grew {grown} KiB"
    tok, pos = specs.decode_inputs(cfg, SHAPES["decode_32k"])
    assert tok.shape == (128, 1) and pos.shape == () and tok.is_meta
