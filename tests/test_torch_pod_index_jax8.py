"""The port's pod index against the JAX package's on a 2 x 4 mesh.

The mirror of ``tests/test_spmd.py``'s
``test_distributed_index_matches_single_device``.  The JAX package runs
``build_distributed`` / ``query_distributed`` / ``brute_force_distributed``
on 8 forced host devices in one child process (the device count is fixed
at jax's first use, so the child sets its own ``XLA_FLAGS``), and writes
every rank's family, table, and the answers to an ``.npz``.  The port runs
the same calls with those families on 8 ``cpu`` ranks in this process:
tables equal, ids equal wherever distances are distinct, distances allclose
at the tolerance ``tests/test_torch_index.py`` holds ``query_index`` to
(rtol 1e-5, atol 1e-6), recall above 0.5, and the nearest answer's
distance the true one.

The child inherits no ``REPRO_*`` variable and has a 300 s timeout.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
CFG_KW = dict(n_dims=32, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=4.0)

_CHILD = """
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import compat
    from repro.core import distributed, index as lidx
    assert jax.device_count() == 8, jax.devices()
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(11)
    db = rng.normal(size=(512, 32)).astype(np.float32)
    q = (rng.normal(size=(16, 32)) * 0.9).astype(np.float32)
    cfg = lidx.IndexConfig(**{cfg_kw!r})
    key = jax.random.PRNGKey(0)
    state = distributed.build_distributed(key, cfg, jnp.asarray(db), mesh)
    ids, dists = distributed.query_distributed(state, cfg, jnp.asarray(q),
                                               10, mesh, n_probes=6)
    eids, edists = distributed.brute_force_distributed(
        jnp.asarray(db), jnp.asarray(q), 10, mesh)
    np.savez(sys.argv[1], db=db, q=q, alpha=np.asarray(state.alpha),
             b=np.asarray(state.b), mix=np.asarray(state.mix),
             table=np.asarray(state.table), counts=np.asarray(state.counts),
             ids=np.asarray(ids), dists=np.asarray(dists),
             eids=np.asarray(eids), edists=np.asarray(edists))
    print("OK")
"""


def _assert_topk(ids_t, d_t, ids_j, d_j):
    fin = np.isfinite(d_j)
    assert (np.isfinite(d_t) == fin).all()
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=RTOL, atol=ATOL)
    for r in range(d_j.shape[0]):
        for c in range(d_j.shape[1]):
            others = np.delete(d_j[r], c)
            if fin[r, c] and not np.isclose(others, d_j[r, c], rtol=RTOL,
                                            atol=ATOL).any():
                assert ids_t[r, c] == ids_j[r, c], (r, c)
    assert ((ids_t == -1) == ~fin).all()


def test_pod_index_matches_the_jax_packages_8_device_run(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    path = tmp_path / "jax8.npz"
    out = subprocess.run(
        [sys.executable, "-c",
         textwrap.dedent(_CHILD.replace("{cfg_kw!r}", repr(CFG_KW))),
         str(path)], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
    j = dict(np.load(path))
    assert j["alpha"].shape[:2] == (2, 4)

    cfg = tidx.IndexConfig(**CFG_KW)
    mesh = make_test_mesh((2, 4), device="cpu")
    fams = [[(j["alpha"][di, mi], j["b"][di, mi], j["mix"][di, mi])
             for mi in range(4)] for di in range(2)]
    pod = tdist.build_distributed(cfg, j["db"], mesh, families=fams)
    for di in range(2):
        for mi in range(4):
            np.testing.assert_array_equal(pod[di][mi].table.numpy(),
                                          j["table"][di, mi])
            np.testing.assert_array_equal(pod[di][mi].counts.numpy(),
                                          j["counts"][di, mi])
    ids, dists = tdist.query_distributed(pod, cfg, j["q"], 10, n_probes=6)
    _assert_topk(ids.numpy(), dists.numpy(), j["ids"], j["dists"])
    eids, edists = tdist.brute_force_distributed(j["db"], j["q"], 10, mesh)
    _assert_topk(eids.numpy(), edists.numpy(), j["eids"], j["edists"])

    recall = float(tidx.recall_at_k(ids, eids))
    assert recall > 0.5
    d0 = np.linalg.norm(j["db"][int(ids[0, 0])] - j["q"][0])
    np.testing.assert_allclose(float(d0), float(dists[0, 0]), rtol=1e-4)
