"""The port's independent-family pod index against the JAX package's, on
the CPU.

* Each rank's family is the JAX package's own draw (``fold_in(fold_in(key,
  di), mi)`` -> ``make_family``), handed over as numpy; each rank's table
  and counts equal the JAX ``create_index`` + ``build_index`` of its block,
  with hash-boundary flips counted (none away from a boundary).
* ``query_distributed`` and ``brute_force_distributed`` against the JAX
  package's on a 1 x 1 mesh (one CPU device, the reference's own merge).
* The fan-in against a numpy transcription of the JAX fan-in
  (``repro/core/distributed.py:113-131``) on 2 x 4 ranks' hand-made lists:
  copies of an item across model shards, equal distances on different
  ids, fewer than k hits.
* Brute force against ``brute_force_topk`` over the whole db.
* The errors, the mesh, and the toy cell (``launch/lsh_cell.py``).

Tolerances are those ``tests/test_torch_index.py`` holds ``query_index``
to: ids equal wherever distances are distinct, distances rtol 1e-5, atol
1e-6.  All data comes from numpy seeds; nothing here changes process-wide
state or starts a process.
"""

import importlib.util
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import index as jidx  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.launch import lsh_cell, mesh as tmesh  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N_DIMS = 32
CFG_KW = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=4.0)
CFG_J, CFG_T = jidx.IndexConfig(**CFG_KW), tidx.IndexConfig(**CFG_KW)

_jbuild = jax.jit(jidx.build_index, static_argnums=1)
_jhash = jax.jit(jidx.hash_stage, static_argnums=2)


def _data(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, N_DIMS)).astype(
        np.float32)


def _queries(db, nq=16, seed=2):
    rng = np.random.default_rng(seed)
    return (db[:nq] + 0.3 * rng.normal(size=(nq, N_DIMS))).astype(np.float32)


def _jax_families(d, m, key=0):
    """Rank (di, mi)'s family as the JAX package draws it inside
    ``build_distributed`` (``core/distributed.py:75``), as numpy."""
    base = jax.random.PRNGKey(key)
    return [[tuple(np.asarray(a) for a in jidx.make_family(
        jax.random.fold_in(jax.random.fold_in(base, di), mi), CFG_J))
        for mi in range(m)] for di in range(d)]


def _near_boundary(fam, x, tol=1e-4):
    """Rows of ``x`` whose pre-floor projection under ``fam`` lies within
    ``tol`` of an integer: a float-order difference may floor them either
    way."""
    _, proj = _jhash(jnp.asarray(fam[0]), jnp.asarray(fam[1]), CFG_J,
                     jnp.asarray(x))
    proj = np.asarray(proj).reshape(x.shape[0], -1)
    return (np.abs(proj - np.round(proj)) < tol).any(axis=1)


def _hash_flips(fam, x):
    """Rows of ``x`` the two packages hash apart under ``fam``; asserts
    each lies near a floor boundary (``_near_boundary``)."""
    ht, _ = tidx.hash_stage(torch.tensor(fam[0]), torch.tensor(fam[1]),
                            CFG_T, torch.tensor(x))
    hj, _ = _jhash(jnp.asarray(fam[0]), jnp.asarray(fam[1]), CFG_J,
                   jnp.asarray(x))
    differ = (ht.numpy() != np.asarray(hj)).reshape(x.shape[0], -1).any(
        axis=1)
    assert not (differ & ~_near_boundary(fam, x)).any()
    return int(differ.sum())


def _assert_topk(ids_t, d_t, ids_j, d_j):
    """Ids equal wherever the reference's distances are distinct within
    their row; distances allclose."""
    ids_t, d_t = np.asarray(ids_t), np.asarray(d_t)
    ids_j, d_j = np.asarray(ids_j), np.asarray(d_j)
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


# -- the build ----------------------------------------------------------------


def test_each_rank_builds_the_jax_shards_table_from_its_family():
    d, m = 2, 4
    db = _data(512)
    n_local = 256
    fams = _jax_families(d, m)
    pod = tdist.build_distributed(CFG_T, db, tmesh.make_test_mesh(
        (d, m), device="cpu"), families=fams)
    assert len(pod) == d and all(len(row) == m for row in pod)
    flips = 0
    for di in range(d):
        block = db[di * n_local:(di + 1) * n_local]
        for mi in range(m):
            fam = fams[di][mi]
            sj = _jbuild(jidx.create_index(
                jax.random.PRNGKey(0), CFG_J, n_local,
                family=tuple(jnp.asarray(a) for a in fam)), CFG_J,
                jnp.asarray(block))
            st = pod[di][mi]
            np.testing.assert_array_equal(st.alpha.numpy(), fam[0])
            np.testing.assert_array_equal(st.mix.numpy(),
                                          fam[2].astype(np.int64))
            np.testing.assert_array_equal(st.db.numpy(), block)
            flipped = _hash_flips(fam, block)
            flips += flipped
            if not flipped:
                np.testing.assert_array_equal(st.table.numpy(),
                                              np.asarray(sj.table))
                np.testing.assert_array_equal(st.counts.numpy(),
                                              np.asarray(sj.counts))
    assert flips == 0


def test_model_shards_of_a_block_share_rows_and_draw_their_own_families():
    mesh = tmesh.make_test_mesh((2, 3), device="cpu")
    db = _data(300)
    pod = tdist.build_distributed(CFG_T, db, mesh, seed=7)
    again = tdist.build_distributed(CFG_T, db, mesh, seed=7)
    for di, row in enumerate(pod):
        for mi, st in enumerate(row):
            assert st.db is row[0].db
            gen = torch.Generator().manual_seed(
                tdist.family_seed(7, di, mi, 3))
            alpha, b, mix = tidx.make_family(gen, CFG_T)
            assert torch.equal(st.alpha, alpha) and torch.equal(st.mix, mix)
            assert torch.equal(st.table, again[di][mi].table)
    alphas = [st.alpha for row in pod for st in row]
    assert all(not torch.equal(alphas[0], a) for a in alphas[1:])


def test_bf16_items_are_cast_to_fp32_at_insert():
    mesh = tmesh.make_test_mesh((2, 2), device="cpu")
    x = torch.as_tensor(_data(128)).to(torch.bfloat16)
    pod = tdist.build_distributed(CFG_T, x, mesh, seed=3)
    ref = tdist.build_distributed(CFG_T, x.float().numpy(), mesh, seed=3)
    for row, row_r in zip(pod, ref):
        for st, st_r in zip(row, row_r):
            assert st.db.dtype == torch.float32
            assert torch.equal(st.db, st_r.db)
            assert torch.equal(st.table, st_r.table)


# -- against the JAX package on a 1 x 1 mesh ----------------------------------


@pytest.mark.parametrize("n_probes", [1, 6])
def test_query_and_brute_force_match_jax_on_a_1x1_mesh(n_probes):
    db, mesh_j = _data(512, seed=3), compat.make_mesh((1, 1),
                                                      ("data", "model"))
    q = _queries(db, seed=4)
    sj = jdist.build_distributed(jax.random.PRNGKey(0), CFG_J,
                                 jnp.asarray(db), mesh_j)
    fam = (np.asarray(sj.alpha[0, 0]), np.asarray(sj.b[0, 0]),
           np.asarray(sj.mix[0, 0]))
    assert _hash_flips(fam, np.concatenate([db, q])) == 0
    ij, dj = jdist.query_distributed(sj, CFG_J, jnp.asarray(q), 10, mesh_j,
                                     n_probes=n_probes)
    ej, edj = jdist.brute_force_distributed(jnp.asarray(db), jnp.asarray(q),
                                            10, mesh_j)
    mesh_t = tmesh.make_test_mesh((1, 1), device="cpu")
    pod = tdist.build_distributed(CFG_T, db, mesh_t, families=[[fam]])
    np.testing.assert_array_equal(pod[0][0].table.numpy(),
                                  np.asarray(sj.table[0, 0]))
    it, dt = tdist.query_distributed(pod, CFG_T, q, 10, n_probes=n_probes)
    assert it.dtype == torch.int32 and dt.dtype == torch.float32
    _assert_topk(it.numpy(), dt.numpy(), ij, dj)
    et, edt = tdist.brute_force_distributed(db, q, 10, mesh_t)
    _assert_topk(et.numpy(), edt.numpy(), ej, edj)


# -- the fan-in ---------------------------------------------------------------


def _jax_fan_in(all_ids, all_d, k):
    """``repro/core/distributed.py:113-131`` in numpy: all_ids / all_d
    (D*M, nq, k) in all-gather order."""
    nd, nq, _ = all_ids.shape
    flat_ids = all_ids.transpose(1, 0, 2).reshape(nq, nd * k)
    flat_d = all_d.transpose(1, 0, 2).reshape(nq, nd * k)
    order = np.argsort(flat_ids, axis=-1, kind="stable")
    s_ids = np.take_along_axis(flat_ids, order, axis=-1)
    s_d = np.take_along_axis(flat_d, order, axis=-1)
    dup = np.concatenate([np.zeros_like(s_ids[:, :1], dtype=bool),
                          s_ids[:, 1:] == s_ids[:, :-1]], axis=-1)
    s_d = np.where(dup | (s_ids < 0), np.inf, s_d)
    pick = np.argsort(s_d, axis=-1, kind="stable")[:, :k]   # lax.top_k(-d)
    out_d = np.take_along_axis(s_d, pick, axis=-1)
    out_ids = np.take_along_axis(s_ids, pick, axis=-1)
    return np.where(np.isinf(out_d), -1, out_ids), out_d


def _rank_lists(seed, d=2, m=4, nq=6, k=5, n_local=40):
    """Each rank's ascending (nq, k) list as ``query_distributed`` makes
    it: global ids of its data block, (-1, +inf) past its hits; the same
    item from two model shards of a block carries the same distance, and
    distances repeat on different ids."""
    rng = np.random.default_rng(seed)
    levels = np.round(rng.uniform(0, 3, size=(d, nq, n_local)), 1).astype(
        np.float32)                                 # coarse: many ties
    ids = np.full((d * m, nq, k), -1, np.int32)
    dist = np.full((d * m, nq, k), np.inf, np.float32)
    for di in range(d):
        for mi in range(m):
            for r in range(nq):
                hits = rng.choice(n_local, size=rng.integers(0, k + 1),
                                  replace=False)
                key = sorted(hits, key=lambda i: (levels[di, r, i], i))
                for c, i in enumerate(key):
                    ids[di * m + mi, r, c] = i + di * n_local
                    dist[di * m + mi, r, c] = levels[di, r, i]
    return ids, dist


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fan_in_matches_the_jax_fan_in(seed):
    k = 5
    ids, dist = _rank_lists(seed, k=k)
    counts = np.unique(ids[ids >= 0], return_counts=True)[1]
    assert (counts > 1).any()                        # copies across shards
    assert (ids == -1).any()                         # fewer than k hits
    want_i, want_d = _jax_fan_in(ids, dist, k)
    got_i, got_d = tdist.fan_in([torch.as_tensor(x) for x in dist],
                                [torch.as_tensor(x) for x in ids], k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    for row in got_i.numpy():
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == len(kept)


def test_fan_in_pads_rows_with_no_hit():
    ids = np.full((8, 2, 3), -1, np.int32)
    dist = np.full((8, 2, 3), np.inf, np.float32)
    ids[5, 1, 0], dist[5, 1, 0] = 77, 0.5
    g, d = tdist.fan_in([torch.as_tensor(x) for x in dist],
                        [torch.as_tensor(x) for x in ids], 3)
    assert g.tolist() == [[-1, -1, -1], [77, -1, -1]]
    assert d[1, 0] == 0.5 and torch.isinf(d[0]).all()
    assert torch.isinf(d[1, 1:]).all()


# -- brute force ---------------------------------------------------------------


@pytest.mark.parametrize("shape,p", [((2, 4), 2.0), ((4, 1), 2.0),
                                     ((2, 2), 1.0)])
def test_brute_force_matches_brute_force_topk(shape, p, monkeypatch):
    monkeypatch.setattr(tdist, "BRUTE_CHUNK_MAX", 48)   # several chunks
    db = _data(400, seed=5)
    q = _queries(db, nq=12, seed=6)
    ids, dist = tdist.brute_force_distributed(
        db, q, 10, tmesh.make_test_mesh(shape, device="cpu"), p=p)
    want_i, want_d = tidx.brute_force_topk(torch.as_tensor(db),
                                           torch.as_tensor(q), 10, p=p)
    assert ids.dtype == torch.int32
    _assert_topk(ids.numpy(), dist.numpy(), want_i.numpy(), want_d.numpy())


def test_brute_force_lists_hold_each_blocks_exact_top_k(monkeypatch):
    """Before the last merge: block di's k columns are the exact top k of
    block di alone, ids made global; block 0's chunk lists merge to the
    same."""
    monkeypatch.setattr(tdist, "BRUTE_CHUNK_MAX", 48)
    db = _data(400, seed=7)
    q = _queries(db, nq=12, seed=8)
    d_ranks, k, n_local = 4, 10, 100
    dist, gids = tdist.brute_force_lists(
        db, q, k, tmesh.make_test_mesh((d_ranks, 2), device="cpu"))
    assert dist.shape == gids.shape == (12, d_ranks * k)
    assert gids.dtype == torch.int32
    for di in range(d_ranks):
        block = torch.as_tensor(db[di * n_local:(di + 1) * n_local])
        want_i, want_d = tidx.brute_force_topk(block, torch.as_tensor(q), k)
        cols = slice(di * k, (di + 1) * k)
        _assert_topk(gids[:, cols].numpy(), dist[:, cols].numpy(),
                     want_i.numpy() + di * n_local, want_d.numpy())
    cd, ci = tdist.block_lists(torch.as_tensor(db[:n_local]),
                               torch.as_tensor(q), k)
    assert cd.shape == (12, 2 * k + 4)   # chunks of 48, 48 and 4 rows
    md, mi = ops.merge_topk(cd, ci, k)
    assert torch.equal(mi, gids[:, :k]) and torch.equal(md, dist[:, :k])


def test_brute_force_breaks_ties_by_the_lower_id(monkeypatch):
    monkeypatch.setattr(tdist, "BRUTE_CHUNK_MAX", 5)
    db = np.zeros((24, N_DIMS), np.float32)
    db[::3, 0] = 1.0                      # eight rows at distance 0 ...
    q = np.zeros((2, N_DIMS), np.float32)
    q[:, 0] = 1.0
    ids, dist = tdist.brute_force_distributed(
        db, q, 10, tmesh.make_test_mesh((2, 2), device="cpu"))
    assert ids[0].tolist() == [0, 3, 6, 9, 12, 15, 18, 21, 1, 2]
    assert dist[0, :8].eq(0).all() and dist[0, 8:].eq(1).all()


def test_the_pod_query_finds_true_neighbours_on_2x4():
    mesh = tmesh.make_test_mesh((2, 4), device="cpu")
    db = _data(512, seed=8)
    q = _queries(db, seed=9)
    pod = tdist.build_distributed(CFG_T, db, mesh, seed=0)
    ids, dist = tdist.query_distributed(pod, CFG_T, q, 10, n_probes=6)
    eids, _ = tdist.brute_force_distributed(db, q, 10, mesh)
    assert float(tidx.recall_at_k(ids, eids)) > 0.5
    ok = ids >= 0
    true = np.linalg.norm(db[ids.clamp(min=0).numpy()] - q[:, None], axis=-1)
    np.testing.assert_allclose(dist.numpy()[ok.numpy()],
                               true[ok.numpy()], rtol=1e-4)
    for row in ids.numpy():
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == len(kept)


# -- errors and the mesh -------------------------------------------------------


def test_items_that_do_not_split_over_the_data_axis_raise():
    mesh = tmesh.make_test_mesh((3, 2), device="cpu")
    with pytest.raises(ValueError, match="equal data blocks"):
        tdist.build_distributed(CFG_T, _data(100), mesh)
    with pytest.raises(ValueError, match="equal data blocks"):
        tdist.brute_force_distributed(_data(100), _data(4), 3, mesh)


def test_a_card_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tmesh.make_test_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh()


def test_the_meshes_have_the_jax_shapes():
    mesh = tmesh.make_test_mesh(device="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert [str(d) for row in mesh.devices for d in row] == ["cpu"] * 8
    prod = tmesh.make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16}
    with pytest.raises(ValueError):
        tmesh.PodMesh(devices=((torch.device("cpu"),), ()))


def test_the_mesh_module_touches_no_device_at_import(monkeypatch):
    """A private copy of ``launch/mesh.py`` loads with every device query
    of ``torch.cuda`` raising (the copy leaves ``sys.modules`` with the
    test)."""
    def refuse(*a, **k):
        raise AssertionError("a device was touched at import")
    for name in ("is_available", "device_count", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    spec = importlib.util.spec_from_file_location(
        "repro_torch.launch._mesh_copy", tmesh.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    assert mod.make_pod_mesh((1, 2), device="cpu").shape == {"data": 1,
                                                             "model": 2}


# -- the cell ------------------------------------------------------------------


TPU_WORDS = ("flops_per_chip", "t_compute", "t_collective", "collective",
             "hlo", "temp_gib")


def test_the_toy_cell_writes_its_entries(tmp_path):
    out = tmp_path / "cell.json"
    out.write_text(json.dumps({"single/earlier": {"kept": 1}}))
    res = lsh_cell.main(["--device", "cpu", "--n-items", "2048",
                         "--queries", "32", "--mesh", "2,2",
                         "--tables-per-shard", "1", "--seed", "3",
                         "--out", str(out)])
    data = json.loads(out.read_text())
    phases = ("lsh_build", "lsh_query", "brute_force_query")
    assert set(data) == {"single/earlier"} | {f"single/{p}_f32_L1"
                                              for p in phases}
    for p in phases:
        e = data[f"single/{p}_f32_L1"]
        for key in ("card_ms", "host_ms", "bound_ms", "bound_by", "bytes",
                    "ops", "peak_bytes", "launches", "recall_at_10",
                    "held_share", "mesh", "cell"):
            assert key in e, (p, key)
        assert e["card_ms"] is None and e["peak_bytes"] is None   # CPU
        assert e["host_ms"] > 0 and e["bound_ms"] > 0 and e["bytes"] > 0
        assert 0.0 <= e["recall_at_10"] <= 1.0
        assert 0.0 < e["held_share"] <= 1.0
        assert e["cell"]["mesh"] == [2, 2] and e["cell"]["n_items"] == 2048
    text = out.read_text()
    assert not any(w in text for w in TPU_WORDS)
    for const in (197e12, 819e9, 50e9):          # the JAX roofline's TPU
        assert repr(const) not in text and str(int(const)) not in text
    assert res["cell"]["recall_at_10"] == data[
        "single/lsh_query_f32_L1"]["recall_at_10"]
    assert res["cell"]["brute_force_finite"]
    # the cell counts its path's launches by kernel; the CPU launches none
    assert res["cell"]["launches"] == {name: 0 for name in dispatch.KERNELS}


def test_the_toy_cell_is_seeded():
    kw = dict(n_items=1024, n_queries=16, mesh_shape=(2, 1), device="cpu",
              tables_per_shard=1, log=lambda *a: None)
    a = lsh_cell.run(seed=5, **kw)["cell"]
    b = lsh_cell.run(seed=5, **kw)["cell"]
    for key in ("recall_at_10", "held_share", "query_work"):
        assert a[key] == b[key]
