"""The port's stacked single-device fan-out, on the CPU.

``SegmentedIndex.query`` scores every sealed segment at once over a stack
of their leaves (``repro_torch.sharding.placement``,
``repro_torch.core.distributed``).  Here it is held:

* against the JAX package: the same gids as its unsharded query and as
  its 1-device-mesh ``shard`` query, distances allclose (rtol 1e-5, atol
  1e-6: the JAX and torch plain versions sum in other orders), at fp32,
  int8 and bf16 and at 1 and 4 probes, with one numpy family in both;
* against the port's own per-segment fan-out (``_query_fanout``), bit for
  bit (gids equal, distances ``torch.equal``): deletes, a fully tombstoned
  segment, a delta-only and an empty index, seals across two doublings of
  the stack, and both dedup routes;
* for a number of kernel calls that does not grow with the segment count;
* K5's plain version with one scale per segment against one call per
  segment; the stack's doubling and shrink widths against the JAX
  package's ``_headroom_per_dev``; the views a sealed segment keeps into
  the stack; and the vectorised survivor gather against the loop it
  replaced.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import index as jidx  # noqa: E402
from repro.serve import SegmentedIndex as JSegmentedIndex  # noqa: E402
from repro.sharding import placement as jplacement  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.kernels import ops, quantize, ref  # noqa: E402
from repro_torch.serve import SegmentedIndex  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402

N_DIMS = 16
CFG_KW = dict(n_dims=N_DIMS, n_tables=4, n_hashes=4, log2_buckets=8,
              bucket_capacity=64, r=2.0)
CFG_J, CFG_T = jidx.IndexConfig(**CFG_KW), tidx.IndexConfig(**CFG_KW)
PRECISIONS = ("fp32", "int8", "bf16")


def _family(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_DIMS, 16)).astype(np.float32),
            rng.uniform(size=(16,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(4, 4)) | 1).astype(np.uint32))


def _data(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _port(precision="fp32"):
    return SegmentedIndex(CFG_T, segment_capacity=64, insert_chunk=32,
                          device="cpu", precision=precision,
                          family=convert.family_from_numpy(*_family(),
                                                           device="cpu"))


def _jax(precision="fp32"):
    return JSegmentedIndex(CFG_J, segment_capacity=64, insert_chunk=32,
                           precision=precision,
                           family=tuple(jnp.asarray(a) for a in _family()))


def _assert_bit_equal(got, want):
    assert got[0].dtype == want[0].dtype == torch.int32
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


# -- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n_probes", [1, 4])
def test_stacked_query_equals_jax_unsharded_and_one_device_mesh(precision,
                                                                n_probes):
    js, ts = _jax(precision), _port(precision)
    emb = _data(420, seed=1)
    for part in (emb[:100], emb[100:333], emb[333:]):
        np.testing.assert_array_equal(ts.insert(part), js.insert(part))
    dead = np.concatenate([np.arange(0, 420, 7), np.arange(64, 128)])
    assert js.delete(dead) == ts.delete(dead)
    assert len(ts.segments) == len(js.segments) == 7
    q = _data(9, seed=2, scale=0.9)
    want_g, want_d = js.query(q, 10, n_probes=n_probes)
    js.shard(compat.make_mesh((1,), ("serve",)))
    mesh_g, mesh_d = js.query(q, 10, n_probes=n_probes)
    got_g, got_d = ts.query(q, 10, n_probes=n_probes)
    assert got_g.dtype == torch.int32 and got_d.dtype == torch.float32
    for g, d in ((want_g, want_d), (mesh_g, mesh_d)):
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(g))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(d), rtol=1e-5,
                                   atol=1e-6)
    assert (got_g >= 0).any()


# -- against the port's own per-segment fan-out -------------------------------


def _filled(precision, n, delete=()):
    ts = _port(precision)
    if n:
        ts.insert(_data(n, seed=3))
    if len(delete):
        ts.delete(delete)
    return ts


# (items, deletes): deletes in sealed segments and in the delta; segment 1
# fully tombstoned; a delta-only index; an empty one; 5 sealed segments
# (the stack doubled 1 -> 2 -> 4 -> 8)
CASES = {
    "deletes": (300, np.concatenate([np.arange(3, 300, 5), [290, 299]])),
    "dead_segment": (200, np.arange(64, 128)),
    "delta_only": (40, np.array([1, 2, 30])),
    "empty": (0, np.array([], np.int64)),
    "doublings": (5 * 64 + 17, np.arange(0, 337, 11)),
}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_probes", [1, 4])
def test_stacked_query_bit_equal_to_fanout(precision, case, n_probes):
    n, dead = CASES[case]
    ts = _filled(precision, n, delete=dead)
    q = np.concatenate([_data(7, seed=4, scale=0.9), _data(3, seed=3)])
    got = ts.query(q, 10, n_probes=n_probes)
    frac = ts.rerank_survivor_frac
    want = ts._query_fanout(q, 10, n_probes=n_probes)
    _assert_bit_equal(got, want)
    assert ts.rerank_survivor_frac == frac
    if case == "empty":
        assert (got[0] == -1).all() and torch.isinf(got[1]).all()
    else:
        assert (got[0] >= 0).any()
    if case == "doublings":
        assert ts.layout()["n_sealed"] == 5 and ts.layout()["s_cap"] == 8


@pytest.mark.parametrize("limit", ["scatter", "sort"])
def test_dedup_route_is_chosen_per_segment(limit, monkeypatch):
    """Between nq * cap and S * nq * cap the route must stay the scatter
    table (chosen per segment); below nq * cap both go to the sort."""
    ts = _filled("fp32", 5 * 64 + 9, delete=np.arange(0, 329, 13))
    q = _data(6, seed=8)
    cap = ts.segment_capacity
    monkeypatch.setattr(tidx, "DEDUP_SCATTER_MAX_ELEMS",
                        6 * cap if limit == "scatter" else 6 * cap - 1)
    _assert_bit_equal(ts.query(q, 10, n_probes=4),
                      ts._query_fanout(q, 10, n_probes=4))


def test_stacked_gather_rows_equal_each_segments_own():
    ts = _filled("fp32", 4 * 64 + 5, delete=np.arange(0, 261, 3))
    q = torch.as_tensor(_data(5, seed=9))
    st = ts.delta.state
    h, pj = tidx.hash_stage(st.alpha, st.b, CFG_T, q)
    bk = tidx.probe_stage(st.mix, CFG_T, h, pj, 4)
    table, _, _, live, _ = ts._stack.sealed()
    stacked = tidx.gather_stage(table, bk, CFG_T, 64, live_mask=live)
    assert stacked.shape == (4, 5, 4 * 4 * 64)
    for s, seg in enumerate(ts.segments[:-1]):
        own = tidx.gather_stage(seg.state.table, bk, CFG_T, 64,
                                live_mask=seg.live)
        assert torch.equal(stacked[s], own)
    rows = tidx.flat_rows(stacked, 64)
    assert rows.dtype == torch.int32 and rows.shape == (20, 1024)
    assert torch.equal(rows[5:10], torch.where(stacked[1] >= 0,
                                               stacked[1] + 64, -1))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_kernel_calls_do_not_grow_with_segments(precision, monkeypatch):
    """One hash, one scorer call over the sealed stack and one over the
    delta, one merge (two more on a quantized tier: the rescore), whatever
    the segment count; the fan-out's grow with it."""
    calls = {}
    for name in ("pstable_hash_proj", "fused_query_topk",
                 "quantized_query_topk", "merge_topk",
                 "candidate_distances"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    seen = []
    for n in (3 * 64 + 7, 9 * 64 + 7):
        ts = _filled(precision, n)
        calls.clear()
        ts.query(_data(4, seed=5), 10, n_probes=4)
        seen.append(dict(calls))
    assert seen[0] == seen[1]
    scorer = "fused_query_topk" if precision == "fp32" else \
        "quantized_query_topk"
    assert seen[0]["pstable_hash_proj"] == 1
    assert seen[0][scorer] == 1 + (precision == "fp32")
    assert seen[0].get("fused_query_topk", 0) == 1 + (precision == "fp32")
    assert seen[0]["merge_topk"] == (1 if precision == "fp32" else 2)
    calls.clear()
    ts._query_fanout(_data(4, seed=5), 10, n_probes=4)
    assert calls["pstable_hash_proj"] == 10


# -- K5 with one scale per segment --------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("p", [2.0, 1.0, 1.5])
def test_quantized_ref_per_segment_scale_equals_separate_calls(dtype, p):
    gen = torch.Generator().manual_seed(11)
    n_seg, nq, cap, c, k = 5, 6, 64, 96, 12
    tier = "int8" if dtype == torch.int8 else "bf16"
    codes, scales = [], []
    for s in range(n_seg):
        cd, sc = quantize.encode(torch.randn((cap, N_DIMS), generator=gen)
                                 * (s + 1), tier)
        codes.append(cd)
        scales.append(sc)
    q = torch.randn((nq, N_DIMS), generator=gen) * 2
    ids = torch.randint(-1, cap, (n_seg, nq, c), generator=gen,
                        dtype=torch.int32)
    rows = tidx.flat_rows(ids, cap)
    d, i = ref.quantized_topk_ref(q.repeat(n_seg, 1), torch.cat(codes),
                                  torch.stack(scales), rows, k, p=p)
    for s in range(n_seg):
        ds, is_ = ref.quantized_topk_ref(q, codes[s], scales[s], ids[s], k,
                                         p=p)
        assert torch.equal(d[s * nq:(s + 1) * nq].view(torch.int32),
                           ds.view(torch.int32))
        assert torch.equal(i[s * nq:(s + 1) * nq],
                           torch.where(is_ >= 0, is_ + s * cap, -1))
    # one scale in a (1,) tensor is the () scale
    d1, i1 = ref.quantized_topk_ref(q, codes[0], scales[0].reshape(1),
                                    ids[0], k, p=p)
    d0, i0 = ref.quantized_topk_ref(q, codes[0], scales[0], ids[0], k, p=p)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


# -- the stack ----------------------------------------------------------------


def test_headroom_widths_match_the_jax_placement():
    needs = [1, 2, 3, 4, 5, 8, 9, 17, 17, 16, 12, 9, 8, 5, 4, 3, 2, 1, 0, 1,
             3, 40, 10, 9, 1, 0, 0, 6]
    prev_j, prev_t = None, 0
    for need in needs:
        want = jplacement._headroom_per_dev(need, prev_j, "mesh", "serve", 1)
        got = placement.headroom(need, prev_t)
        assert got == want, (need, prev_t)
        prev_j = types.SimpleNamespace(mesh="mesh", axis="serve", n_dev=1,
                                       per_dev=want)
        prev_t = got


@pytest.mark.parametrize("precision", PRECISIONS)
def test_sealed_segments_are_views_of_the_stack(precision):
    ts = _port(precision)
    widths = []
    for _ in range(6):
        ts.insert(_data(64, seed=len(widths)))
        widths.append(ts.layout()["s_cap"])
    ts.maintenance.seal()
    assert widths == [0, 1, 2, 4, 4, 8]            # after 0..5 seals
    lay = ts.layout()
    assert lay["n_sealed"] == 6 and lay["s_cap"] == 8
    st = ts._stack
    for slot, seg in enumerate(ts.segments[:-1]):
        assert seg.sealed and st.segments[slot] is seg
        assert seg.state.db.data_ptr() == st.db[slot].data_ptr()
        assert seg.state.table.data_ptr() == st.table[slot].data_ptr()
        assert seg.live.data_ptr() == st.live[slot].data_ptr()
        assert seg.gids.data_ptr() == st.gids[slot].data_ptr()
        if precision != "fp32":
            assert seg.scale.data_ptr() == st.scale[slot].data_ptr()
            assert np.shares_memory(seg.pool, st.pool)
    assert st.db.dtype == quantize.storage_dtype(precision)
    # headroom is never scored: dead, gids -1
    assert not st.live[6:].any() and (st.gids[6:] == -1).all()
    # a delete through the index is what the stack reads
    assert ts.delete([3, 70, 200]) == 3
    assert not st.live[0, 3] and not st.live[1, 6] and not st.live[3, 8]
    assert ts.segments[0].n_live == 63
    # rebuild with a quarter of the slots' need shrinks; views follow
    keep = ts.segments[:2]
    st.rebuild(keep)
    assert st.s_cap == 4 and st.n_sealed == 2
    assert keep[1].live.data_ptr() == st.live[1].data_ptr()
    assert not st.live[0, 3]
    assert lay["bytes"] == sum(t.nbytes for t in (
        st.db, st.table, st.gids, st.live)) * 2 + (
        0 if precision == "fp32" else 32)


# -- the survivor gather ------------------------------------------------------


def _survivor_rows_loop(index, g_np):
    """The per-gid loop the vectorised gather replaced, kept as its
    reference."""
    nq, m = g_np.shape
    rows = np.zeros((nq, m, index.cfg.n_dims), np.float32)
    host_db: dict = {}
    for qi in range(nq):
        for j in range(m):
            gid = int(g_np[qi, j])
            if gid < 0:
                continue
            loc = index._locator.get(gid)
            if loc is None:
                g_np[qi, j] = -1
                continue
            si, slot = loc
            seg = index.segments[si]
            if seg.pool is not None:
                rows[qi, j] = seg.pool[slot]
            else:
                db = host_db.get(si)
                if db is None:
                    db = seg.state.db.cpu().numpy()
                    host_db[si] = db
                rows[qi, j] = db[slot]
    return rows


def test_survivor_rows_equal_the_loop():
    ts = _port("int8")
    ts.insert(_data(3 * 64 + 20, seed=6))
    ts.delete([5, 70, 200])
    rng = np.random.default_rng(7)
    # sealed int8 rows, fp32-delta rows (gids 192..211), gids never
    # inserted, deleted gids (still located) and empty slots
    g = rng.choice(np.r_[np.arange(212), [500, 10 ** 6, 2 ** 31 - 1]],
                   size=(6, 40)).astype(np.int32)
    g[:, ::9] = -1
    g[0, :3] = [195, 500, 10 ** 6]
    g_loop = g.copy()
    want = _survivor_rows_loop(ts, g_loop)
    got = ts._survivor_rows(g)
    np.testing.assert_array_equal(g, g_loop)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert g[0, 1] == -1 and g[0, 2] == -1 and g[0, 0] == 195
    assert np.abs(got[0, 0]).sum() > 0
