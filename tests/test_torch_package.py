"""Hygiene of the PyTorch port: what it imports, where it runs, packaging.

* No module of ``repro_torch`` (nor ``chip_smoke.py``) imports jax or the
  JAX package ``repro``: checked in a fresh interpreter and from the
  sources' import statements.
* Entry points refuse to run without a card unless asked for the CPU.
* ``convert`` carries a JAX-built index into the port, which then answers
  the same queries.
"""

import ast
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] +
    ["chip_smoke.py"]))
def test_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_multi_device_modules_import_neither_jax_nor_repro():
    """The serve mesh, the router and the placement (its multi-device half
    included) load in a fresh interpreter without jax or repro, and a mesh
    asked of the card refuses to fall back to the CPU when there is none."""
    code = ("import sys\n"
            "import repro_torch.launch.mesh as m\n"
            "import repro_torch.serve.router\n"
            "import repro_torch.sharding.placement as p\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert p.round_robin(3, 2) == [[0, 2], [1]]\n"
            "mesh = m.make_serve_mesh(4, device='cpu')\n"
            "assert [str(d) for d in mesh.devices] == ['cpu'] * 4\n"
            "import torch\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        m.make_serve_mesh(2)\n"
            "    except RuntimeError:\n"
            "        pass\n"
            "    else:\n"
            "        raise AssertionError('a CPU mesh without asking')\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + \
        out.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["hash_mm"])
    assert set(_build.sources()) == {"hash_mm", "dct_mm", "fused_query",
                                     "merge", "quantized_query", "rerank",
                                     "simhash_pack"}


def test_pyproject_ships_the_kernel_sources():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert cfg["project"]["optional-dependencies"]["torch"] == ["torch>=2.3"]
    data = cfg["tool"]["setuptools"]["package-data"]["repro_torch"]
    assert set(data) == {"csrc/*.cu", "csrc/*.cuh"}


def test_convert_round_trip_answers_like_jax():
    cfg_kw = dict(n_dims=16, n_tables=4, n_hashes=4, log2_buckets=8,
                  bucket_capacity=16, r=2.0)
    cfg_j, cfg_t = jidx.IndexConfig(**cfg_kw), tidx.IndexConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    q = x[:12] + 0.05 * rng.normal(size=(12, 16)).astype(np.float32)
    sj = jidx.create_index(jax.random.PRNGKey(7), cfg_j, 332)
    sj = jax.jit(jidx.build_index, static_argnums=1)(sj, cfg_j,
                                                     jnp.asarray(x))
    st = convert.state_from_numpy(*(np.asarray(leaf) for leaf in (
        sj.alpha, sj.b, sj.mix, sj.table, sj.counts, sj.db)), device="cpu")
    assert st.mix.dtype == torch.int64
    np.testing.assert_array_equal(st.mix.numpy(),
                                  np.asarray(sj.mix).astype(np.int64))
    ij, dj = jax.jit(jidx.query_index, static_argnames=(
        "cfg", "k", "n_probes", "backend"))(
        sj, cfg=cfg_j, queries=jnp.asarray(q), k=5, n_probes=2,
        backend="reference")
    it, dt = tidx.query_index(st, cfg_t, q, 5, n_probes=2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    # inserting into the converted state places items as JAX would
    sj2 = jax.jit(jidx.insert_items, static_argnums=1)(
        sj, cfg_j, jnp.asarray(x[:32] + 1.0), jnp.int32(300), jnp.int32(32))
    st2 = tidx.insert_items(st, cfg_t, x[:32] + 1.0, 300, 32)
    for leaf in ("table", "counts", "db"):
        np.testing.assert_array_equal(getattr(st2, leaf).numpy(),
                                      np.asarray(getattr(sj2, leaf)))


def test_the_obs_package_is_covered_and_stdlib_only():
    """``repro_torch.obs`` is in the package (so the import checks above
    cover it), and, like the JAX package's ``obs``, imports nothing but
    the standard library and itself: any layer may import it."""
    obs = [m for m in _modules() if m.startswith("repro_torch.obs")]
    assert obs == ["repro_torch.obs", "repro_torch.obs.export",
                   "repro_torch.obs.metrics", "repro_torch.obs.trace"]
    for path in sorted((PKG / "obs").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in sys.stdlib_module_names | {
                    "__future__"}, (path.name, n)


@pytest.mark.parametrize("name", ["protocol", "client"])
def test_wire_modules_import_only_stdlib_and_numpy(name):
    """``serve/protocol.py`` and ``serve/client.py`` are the port's own
    copies of the JAX package's: the standard library and numpy, and
    nothing of the port beyond the protocol."""
    tree = ast.parse((PKG / "serve" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.module is None and [a.name for a in node.names] \
                    == ["protocol"], ast.dump(node)
                continue
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in sys.stdlib_module_names | {
                "__future__", "numpy"}, (name, n)


def test_front_end_modules_are_in_the_package():
    mods = set(_modules())
    assert {"repro_torch.serve.protocol", "repro_torch.serve.frontend",
            "repro_torch.serve.client"} <= mods
    from repro_torch import serve
    for name in ("Frontend", "FrontendClient", "FrontendError",
                 "RequestGate", "run_server", "wait_ready"):
        assert name in serve.__all__ and hasattr(serve, name)


def test_the_lm_stack_is_covered():
    """The LM stack's modules are in the package, so the import checks
    above (a fresh interpreter; every source's import statements) cover
    them."""
    mods = set(_modules())
    lm = {"repro_torch.configs", "repro_torch.configs.base",
          "repro_torch.configs.registry", "repro_torch.models",
          "repro_torch.models.common", "repro_torch.models.model",
          "repro_torch.models.moe", "repro_torch.models.ssm",
          "repro_torch.models.rglru",
          "repro_torch.optim", "repro_torch.optim.adamw",
          "repro_torch.runtime", "repro_torch.runtime.steps",
          "repro_torch.runtime.driver", "repro_torch.data",
          "repro_torch.data.pipeline", "repro_torch.launch.train",
          "repro_torch.launch.roofline", "repro_torch.convert",
          "repro_torch.sharding.rules", "repro_torch.sharding.context",
          "repro_torch.optim.compress", "repro_torch.launch.specs",
          "repro_torch.launch.dryrun", "repro_torch.launch.report"}
    assert lm <= mods, sorted(lm - mods)
    sources = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for sub in ("configs", "models", "optim", "runtime", "data"):
        assert f"src/repro_torch/{sub}/__init__.py" in sources, sub
