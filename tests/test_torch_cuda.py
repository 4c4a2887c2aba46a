"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  On a machine
with the card (and nvcc), run

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's machine
need not have.)

Tolerances as in ``chip_smoke.py``: projections allclose and hashes equal
away from a bucket boundary, embeddings allclose, top-k distances allclose
with ids equal where distances are distinct, the merge bit-identical
(signs of zero included, but where a row pairs one id with both), the int8
quantized query bit-identical (its sums are exact integers), bf16 tied
distances rtol 1e-5 (K5's contract), the stacked query bit-identical to
the per-segment fan-out, simhash bits equal away from |x @ A| < 1e-5 and
bit-identical to the kernel's fmaf chain.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator().manual_seed(0)


def test_hash_mm_kernel(gen):
    x = torch.randn((40, 64), generator=gen).cuda() * 0.5
    a = torch.randn((64, 32), generator=gen).cuda()
    b = torch.rand((32,), generator=gen).cuda()
    before = dispatch.launches["hash_mm"]
    h, p = ops.pstable_hash_proj(x, a, b, 4.0)
    hp, pp = ref.hash_mm_proj_ref(x, a, b, 4.0)
    assert dispatch.launches["hash_mm"] == before + 1
    torch.testing.assert_close(p, pp, rtol=1e-6, atol=1e-5)
    safe = (pp - torch.round(pp)).abs() > 1e-4
    assert torch.equal(h[safe], hp[safe])
    # a row hashes the same whatever batch it arrives in
    h1, p1 = ops.pstable_hash_proj(x[:8].contiguous(), a, b, 4.0)
    assert torch.equal(p1, p[:8]) and torch.equal(h1, h[:8])


def test_dct_mm_kernel(gen):
    f = torch.randn((77, 64), generator=gen).cuda()
    mt = torch.randn((64, 64), generator=gen).cuda()
    s = torch.rand((64,), generator=gen).cuda()
    torch.testing.assert_close(ops.cheb_embed(f, mt, s),
                               ref.dct_mm_ref(f, mt, s), rtol=1e-5,
                               atol=1e-5)


def _on_card(t, offset):
    """``t`` on the card, ``offset`` elements past an aligned base."""
    flat = torch.empty(offset + t.numel(), dtype=t.dtype, device="cuda")
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("k", [17, 50, 64, 96, 200])
@pytest.mark.parametrize("n", [17, 32, 40, 64])
@pytest.mark.parametrize("m", [1, 8, 32, 33, 128, 256, 300])
def test_small_gemm_kernels_shapes(gen, m, n, k):
    """K1 and K4 (csrc/small_gemm.cuh) at the plan's edges, on aligned
    views and on views 1 float past alignment (the scalar path): K1's
    projections rtol 1e-6 atol 1e-5 and hashes equal away from a bucket
    boundary, K4 rtol 1e-5 atol 1e-5."""
    for offset in (0, 1):
        x = _on_card(torch.randn((m, k), generator=gen) * 0.5, offset)
        a = _on_card(torch.randn((k, n), generator=gen), offset)
        b = _on_card(torch.rand((n,), generator=gen), offset)
        h, p = ops.pstable_hash_proj(x, a, b, 4.0)
        hp, pp = ref.hash_mm_proj_ref(x, a, b, 4.0)
        torch.testing.assert_close(p, pp, rtol=1e-6, atol=1e-5)
        safe = (pp - torch.round(pp)).abs() > 1e-4
        assert torch.equal(h[safe], hp[safe])
        mt = _on_card(torch.randn((k, n), generator=gen) / k ** 0.5, offset)
        s = _on_card(torch.rand((n,), generator=gen), offset)
        torch.testing.assert_close(ops.cheb_embed(x, mt, s),
                                   ref.dct_mm_ref(x, mt, s), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kernel", ["hash_mm", "dct_mm"])
def test_small_gemm_kernels_batch_invariant(gen, kernel):
    """A 256-row call against its 8-, 33- and 128-row slices, each on its
    own plan: bit for bit."""
    x = torch.randn((256, 64), generator=gen).cuda()
    a = torch.randn((64, 32 if kernel == "hash_mm" else 64),
                    generator=gen).cuda()
    v = torch.rand((a.shape[1],), generator=gen).cuda()

    def call(rows):
        if kernel == "hash_mm":
            h, p = ops.pstable_hash_proj(rows, a, v, 4.0)
            return torch.cat([h, p.view(torch.int32)], dim=1)
        return ops.cheb_embed(rows, a, v).view(torch.int32)
    full = call(x)
    for lo, hi in ((0, 8), (5, 38), (128, 256)):
        assert torch.equal(call(x[lo:hi]), full[lo:hi]), (lo, hi)


@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
def test_fused_query_kernel(gen, p):
    q = torch.randn((9, 48), generator=gen).cuda()
    db = torch.randn((300, 48), generator=gen).cuda()
    ids = torch.randint(-1, 300, (9, 200), generator=gen,
                        dtype=torch.int32).cuda()
    ids[0] = -1
    d, i = ops.fused_query_topk(q, db, ids, 10, p=p, valid_items=250)
    dp, ip = ref.fused_query_topk_ref(q, db, ids, 10, p=p, valid_items=250)
    fin = torch.isfinite(dp)
    assert torch.equal(fin, torch.isfinite(d))
    torch.testing.assert_close(d[fin], dp[fin], rtol=1e-5, atol=1e-6)
    distinct = torch.ones_like(fin)
    close = torch.isclose(dp[:, 1:], dp[:, :-1], rtol=1e-5, atol=0)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    assert torch.equal(i[distinct], ip[distinct])
    with pytest.raises(ValueError):
        ops.fused_query_topk(q, db, ids, 129)


@pytest.mark.parametrize("width", [1, 5, 100, 2570])
def test_merge_kernel_bit_identical(gen, width):
    d = torch.round(torch.rand((6, width), generator=gen) * 30) / 30
    d[:, ::5] = torch.inf
    i = torch.randint(-1, 3 * width, (6, width), generator=gen,
                      dtype=torch.int32)
    sd, si = ops.merge_topk(d.cuda(), i.cuda(), 10)
    pd, pi = ops.merge_topk(d, i, 10)
    assert torch.equal(sd.cpu().view(torch.int32), pd.view(torch.int32))
    assert torch.equal(si.cpu(), pi)


def _merge_pairs(gen, rows, m, kind="ties"):
    """(d, i) on the CPU: distances in steps of 1/50 (many ties) with every
    13th +inf and ids in [-1, 4M), or one of the duplicate-heavy kinds."""
    d = torch.round(torch.rand((rows, m), generator=gen) * 50) / 50
    d[:, ::13] = torch.inf
    i = torch.randint(-1, 4 * m, (rows, m), generator=gen, dtype=torch.int32)
    if kind == "empty":                 # every slot (+inf, -1)
        d[:] = torch.inf
        i[:] = -1
    elif kind == "equal":               # one distance, distinct ids
        d[:] = 0.5
        i = torch.argsort(torch.rand((rows, m), generator=gen), dim=1)
        i = i.to(torch.int32)
    elif kind == "repeated":            # a few pairs, each many times
        pick = torch.randint(0, 3, (rows, m), generator=gen)
        d = torch.gather(d[:, :3], 1, pick)
        i = torch.gather(i[:, :3], 1, pick)
    elif kind == "padded":              # a third of the slots empty
        d[:, 1::3] = torch.inf
        i[:, 1::3] = -1
    elif kind == "negative":            # signed distances, no -0.0
        d = d - 0.5
        d[d == 0] = 0.25
        d[:, 5::29] = -torch.inf
    return d, i


def _assert_pairs(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def _merge_plain(d, i, k):
    """ops.merge_topk's CPU route, run on the tensors' own device."""
    dm = torch.where(i < 0, torch.inf, d)
    sd, si = ref.sort_pairs(dm, i)
    sd, si = sd[:, :k], si[:, :k]
    return sd, torch.where(torch.isinf(sd), -1, si)


MERGE_CASES = [(rows, m, k) for rows in (1, 32, 128, 300)
               for m in (1, 5, 40, 2570, 10320, 41280)
               for k in (1, 10, 40, 128) if k <= m]


@pytest.mark.parametrize("rows,m,n_out", MERGE_CASES)
def test_merge_select_route_bit_identical(gen, rows, m, n_out):
    """K3's select route against the plain network's first n_out columns,
    and ops.merge_topk against its CPU route, bit for bit."""
    from repro_torch.kernels import merge
    assert merge.route(rows, m, n_out, 1) == "select"
    d, i = _merge_pairs(gen, rows, m)
    dc, ic = d.cuda(), i.cuda()
    sd, si = ref.sort_pairs(dc, ic)
    _assert_pairs(merge.sort_pairs_kernel(dc, ic, n_out=n_out),
                  (sd[:, :n_out], si[:, :n_out]))
    got = ops.merge_topk(dc, ic, n_out)
    want = (ops.merge_topk(d, i, n_out) if rows * m <= 2 ** 20
            else _merge_plain(dc, ic, n_out))
    _assert_pairs((got[0].cpu(), got[1].cpu()),
                  (want[0].cpu(), want[1].cpu()))


@pytest.mark.parametrize("kind", ["empty", "equal", "repeated", "padded",
                                  "negative"])
@pytest.mark.parametrize("rows,m,n_out", [(32, 2570, 10), (128, 10320, 40),
                                          (128, 40, 10), (5, 300, 128),
                                          (128, 41280, 40), (3, 41280, 128)])
def test_merge_select_route_duplicate_heavy(gen, kind, rows, m, n_out):
    from repro_torch.kernels import merge
    d, i = _merge_pairs(gen, rows, m, kind)
    dc, ic = d.cuda(), i.cuda()
    sd, si = ref.sort_pairs(dc, ic)
    _assert_pairs(merge.sort_pairs_kernel(dc, ic, n_out=n_out),
                  (sd[:, :n_out], si[:, :n_out]))
    if kind != "negative":
        _assert_pairs(ops.merge_topk(dc, ic, n_out),
                      _merge_plain(dc, ic, n_out))


@pytest.mark.parametrize("d_off,i_off", [(1, 1), (3, 3), (1, 2), (0, 3)])
@pytest.mark.parametrize("m", [37, 2570, 10320])
def test_merge_select_route_unaligned_views(gen, m, d_off, i_off):
    """Views at the same offset from a 16-byte boundary take the 16-byte
    loads from the chunks around each row; different offsets the scalar
    loads.  Both bit-identical."""
    from repro_torch.kernels import merge
    d, i = _merge_pairs(gen, 7, m)
    dc, ic = _on_card(d, d_off), _on_card(i, i_off)
    vec = dc.data_ptr() % 16 == ic.data_ptr() % 16
    assert merge.plan(7, m, vec).vec == (d_off % 4 == i_off % 4)
    sd, si = ref.sort_pairs(dc, ic)
    for n_out in (1, 10, 37):
        _assert_pairs(merge.sort_pairs_kernel(dc, ic, n_out=n_out),
                      (sd[:, :n_out], si[:, :n_out]))
        _assert_pairs(ops.merge_topk(dc, ic, n_out),
                      _merge_plain(dc, ic, n_out))


def test_merge_topk_answers_a_100000_pair_row(gen):
    """One row of 100,000 pairs (the network route refused any pool over
    16,384), streamed in tiles by every rank of the cluster."""
    from repro_torch.kernels import merge
    assert merge.plan(1, 100_000).share > merge.MAX_TILE
    d, i = _merge_pairs(gen, 1, 100_000, "padded")
    dc, ic = d.cuda(), i.cuda()
    for k in (10, 40, 128):
        _assert_pairs(ops.merge_topk(dc, ic, k), _merge_plain(dc, ic, k))


def _mixed_zero_slots(d, i, out_d, out_i):
    """Output slots holding a zero distance whose id the row pairs with
    both -0.0 and +0.0: the one case no selection reproduces (the network
    leaves such equal pairs where its compare pattern puts them)."""
    neg = (d == 0) & torch.signbit(d)
    pos = (d == 0) & ~torch.signbit(d)
    same = out_i[:, :, None] == i[:, None, :]
    mixed = (same & neg[:, None, :]).any(-1) & (same & pos[:, None, :]).any(-1)
    return mixed & (out_d == 0)


def _assert_pairs_signed(got, want, d, i):
    """``_assert_pairs``, but at the slots of ``_mixed_zero_slots`` the
    distances are compared as values."""
    assert torch.equal(got[1], want[1])
    exempt = _mixed_zero_slots(d, i, want[0], want[1])
    gd, wd = got[0].view(torch.int32), want[0].view(torch.int32)
    assert torch.equal(gd[~exempt], wd[~exempt])
    assert torch.equal(got[0][exempt], want[0][exempt])


@pytest.mark.parametrize("rows,m,n_out", [(32, 2570, 10), (128, 10320, 40),
                                          (128, 40, 10), (5, 300, 128),
                                          (3, 41280, 128)])
def test_merge_select_route_signed_zeros(gen, rows, m, n_out):
    """Rows whose distances are half +0.0 or -0.0: the select route orders
    them as the plain network does (equal, ties by id), so its ids are the
    network's, and its distances too, bit for bit, signs of zero included,
    but where a row pairs one id with both signs of zero."""
    from repro_torch.kernels import merge
    d, i = _merge_pairs(gen, rows, m)
    pick = torch.randint(0, 4, (rows, m), generator=gen)
    d = torch.where(pick == 0, -0.0, torch.where(pick == 1, 0.0, d))
    dc, ic = d.cuda(), i.cuda()
    sd, si = ref.sort_pairs(dc, ic)
    got = merge.sort_pairs_kernel(dc, ic, n_out=n_out)
    _assert_pairs_signed(got, (sd[:, :n_out], si[:, :n_out]), dc, ic)
    assert torch.signbit(got[0]).any()
    want = _merge_plain(dc, ic, n_out)
    _assert_pairs_signed(ops.merge_topk(dc, ic, n_out), want,
                         torch.where(ic < 0, torch.inf, dc), ic)


def test_merge_topk_signed_zero_probe_row(gen):
    """Sorted by the float's bits, -0.0 would come before +0.0 and give ids
    [3, 5, 9, 1]; the network calls them equal and takes [1, 3, 4, 5],
    each zero with its own sign."""
    d = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, 2.0, -0.0, 0.0]])
    i = torch.tensor([[7, 3, 1, 5, 0, 2, 9, 4]], dtype=torch.int32)
    sd, si = ops.merge_topk(d.cuda(), i.cuda(), 4)
    pd, pi = ops.merge_topk(d, i, 4)
    assert si.tolist() == pi.tolist() == [[1, 3, 4, 5]]
    assert torch.equal(sd.cpu().view(torch.int32), pd.view(torch.int32))
    assert torch.signbit(sd).tolist() == [[False, True, False, True]]


def test_merge_topk_is_one_launch(gen):
    from repro_torch.kernels import merge
    for rows, m, k in ((32, 2570, 10), (128, 10320, 40), (128, 40, 10),
                       (4, 6, 10)):
        d, i = _merge_pairs(gen, rows, m)
        before = dispatch.launches["merge"]
        ops.merge_topk(d.cuda(), i.cuda(), k)
        assert dispatch.launches["merge"] == before + 1
    # the network route keeps its cap, and says which route refused
    d, i = _merge_pairs(gen, 2, 20_000)
    with pytest.raises(ValueError, match="network route"):
        merge.sort_pairs_kernel(d.cuda(), i.cuda())


@pytest.mark.parametrize("rows,m,n_out,run", [(32, 2570, None, 1),
                                              (4, 4096, None, 1),
                                              (3, 300, 200, 1),
                                              (4, 1024, 10, 16)])
def test_merge_network_route_bit_identical(gen, rows, m, n_out, run):
    from repro_torch.kernels import merge
    d, i = _merge_pairs(gen, rows, m)
    if run > 1:
        d = d.reshape(rows, m // run, run).sort(dim=-1).values
        d = d.reshape(rows, m)
    assert merge.route(rows, m, n_out or m, run) == "network"
    dc, ic = d.cuda(), i.cuda()
    sd, si = ref.sort_pairs(dc, ic, sorted_run=run)
    k = n_out or m
    _assert_pairs(merge.sort_pairs_kernel(dc, ic, sorted_run=run,
                                          n_out=n_out),
                  (sd[:, :k], si[:, :k]))


def _quantized_inputs(gen, nq, n, m, c, dtype):
    from repro_torch.kernels import quantize
    db = torch.randn((m, n), generator=gen)
    db[1::7] = db[::7][:db[1::7].shape[0]]            # duplicate rows: ties
    codes, scale = quantize.encode(db, "int8" if dtype == torch.int8
                                   else "bf16")
    amax = db.abs().max()
    q = (db[:nq] + 0.1 * torch.randn((nq, n), generator=gen)).clamp(
        -amax, amax)                      # |q_c| <= 127: sums stay exact
    ids = torch.randint(-1, m, (nq, c), generator=gen, dtype=torch.int32)
    ids[0] = -1
    return q.cuda(), codes.cuda(), scale.cuda(), ids.cuda()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("p", [2.0, 1.0, 1.5])
@pytest.mark.parametrize("k", [1, 40, 128])
def test_quantized_query_kernel(gen, dtype, p, k):
    q, codes, scale, ids = _quantized_inputs(gen, 9, 64, 1024, 600, dtype)
    before = dispatch.launches["quantized_query"]
    d, i = ops.quantized_query_topk(q, codes, scale, ids, k, p=p,
                                    valid_items=900)
    dp, ip = ref.quantized_topk_ref(q, codes, scale, ids, k, p=p,
                                    valid_items=900)
    assert dispatch.launches["quantized_query"] == before + 1
    if dtype == torch.int8 and p in (1.0, 2.0):
        assert torch.equal(d.view(torch.int32), dp.view(torch.int32))
        assert torch.equal(i, ip)
        return
    fin = torch.isfinite(dp)
    assert torch.equal(fin, torch.isfinite(d))
    torch.testing.assert_close(d[fin], dp[fin], rtol=1e-5, atol=1e-6)
    distinct = torch.ones_like(fin)
    close = torch.isclose(dp[:, 1:], dp[:, :-1], rtol=1e-5, atol=0)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    assert torch.equal(i[distinct], ip[distinct])


def test_quantized_query_kernel_refuses_k_over_128(gen):
    q, codes, scale, ids = _quantized_inputs(gen, 2, 64, 300, 200,
                                             torch.int8)
    with pytest.raises(ValueError, match="k=129"):
        ops.quantized_query_topk(q, codes, scale, ids, 129)


def _assert_topk_matches(d, i, dp, ip, exact):
    """Bit for bit when ``exact``; else distances rtol 1e-5 atol 1e-6 and
    ids equal wherever the plain distances are distinct."""
    if exact:
        assert torch.equal(d.view(torch.int32), dp.view(torch.int32))
        assert torch.equal(i, ip)
        return
    fin = torch.isfinite(dp)
    assert torch.equal(fin, torch.isfinite(d))
    assert torch.equal(i[~fin], ip[~fin])                  # the -1 padding
    torch.testing.assert_close(d[fin], dp[fin], rtol=1e-5, atol=1e-6)
    distinct = torch.ones_like(fin)
    close = torch.isclose(dp[:, 1:], dp[:, :-1], rtol=1e-5, atol=0)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    assert torch.equal(i[distinct], ip[distinct])


def _tied_inputs(gen, nq, n, c, dtype):
    """Rows 0..7 of the table are one vector; each query is that vector, so
    ids 0..7 all lie at distance 0.  They sit at slots owned by different
    cluster ranks, in an order unlike their ids: the lower slot must win."""
    from repro_torch.kernels import fused_query, quantize
    db = torch.randn((512, n), generator=gen)
    db[:8] = db[0]
    q = db[0].repeat(nq, 1)
    ids = torch.randint(8, 512, (nq, c), generator=gen, dtype=torch.int32)
    plan = fused_query._plan(nq, c, n, torch.empty((), dtype=dtype)
                             .element_size())
    assert plan.cluster > 1
    g = plan.cluster
    # id j at a slot of rank G - 1 - j: slot order runs against id order
    slots = [(g - 1 - j) + g * (3 + 5 * (g - 1 - j)) for j in range(g)]
    assert sorted(plan.owner(s) for s in slots) == list(range(g))
    for j, s in enumerate(slots):
        ids[:, s] = j
    want = [j for _, j in sorted((s, j) for j, s in enumerate(slots))]
    if dtype == torch.float32:
        return q.cuda(), db.cuda(), None, ids.cuda(), want
    codes, scale = quantize.encode(db, "int8" if dtype == torch.int8
                                   else "bf16")
    return q.cuda(), codes.cuda(), scale.cuda(), ids.cuda(), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("nq", [32, 128])
def test_query_kernels_ties_across_cluster_ranks(gen, dtype, nq):
    q, db, scale, ids, want = _tied_inputs(gen, nq, 64, 1024, dtype)
    k = len(want) + 2
    if dtype == torch.float32:
        d, i = ops.fused_query_topk(q, db, ids, k)
        dp, ip = ref.fused_query_topk_ref(q, db, ids, k)
    else:
        d, i = ops.quantized_query_topk(q, db, scale, ids, k)
        dp, ip = ref.quantized_topk_ref(q, db, scale, ids, k)
    n_tied = len(want)
    if dtype == torch.bfloat16:
        # K5's bf16 contract: the plain version and the kernel sum the 64
        # products in different orders; following the plain order measured
        # slower (tools/probe_sum_order.py)
        torch.testing.assert_close(d[:, :n_tied], dp[:, :n_tied], rtol=1e-5,
                                   atol=0)
    else:
        assert torch.equal(d[:, :n_tied], dp[:, :n_tied])
    assert (d[:, :n_tied] == d[:, :1]).all()
    assert torch.equal(i, ip)
    assert i[:, :n_tied].tolist() == [want] * nq


@pytest.mark.parametrize("k", [1, 10, 40, 128])
@pytest.mark.parametrize("n", [48, 50, 64])
@pytest.mark.parametrize("c", [200, 1000, 1023, 1024])
def test_fused_query_kernel_shapes(gen, c, n, k):
    """C not a multiple of G x S, N = 50 on the scalar instantiation,
    k from 1 to 128; an all-invalid row, a valid_items cut, and a row with
    fewer valid candidates than k."""
    q = torch.randn((32, n), generator=gen).cuda()
    db = torch.randn((1024, n), generator=gen).cuda()
    ids = torch.randint(-1, 1024, (32, c), generator=gen,
                        dtype=torch.int32).cuda()
    ids[0] = -1
    ids[1, :] = -1
    ids[1, : k // 2] = 7                    # fewer valid than k
    before = dispatch.launches["fused_query"]
    d, i = ops.fused_query_topk(q, db, ids, k, valid_items=900)
    assert dispatch.launches["fused_query"] == before + 1
    dp, ip = ref.fused_query_topk_ref(q, db, ids, k, valid_items=900)
    _assert_topk_matches(d, i, dp, ip, exact=False)
    assert (i[0] == -1).all() and torch.isinf(d[0]).all()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 40, 128])
@pytest.mark.parametrize("n", [48, 50, 64])
@pytest.mark.parametrize("c", [200, 1000, 1023, 1024])
def test_quantized_query_kernel_shapes(gen, c, n, k, dtype):
    q, codes, scale, ids = _quantized_inputs(gen, 32, n, 1024, c, dtype)
    ids[1, :] = -1
    ids[1, : k // 2] = 7
    d, i = ops.quantized_query_topk(q, codes, scale, ids, k,
                                    valid_items=900)
    dp, ip = ref.quantized_topk_ref(q, codes, scale, ids, k,
                                    valid_items=900)
    _assert_topk_matches(d, i, dp, ip, exact=dtype == torch.int8)
    assert (i[0] == -1).all() and torch.isinf(d[0]).all()


@pytest.mark.parametrize("p", [2.0, 1.0])
@pytest.mark.parametrize("nq", [32, 128])
def test_quantized_query_kernel_int8_bit_identical(gen, nq, p):
    q, codes, scale, ids = _quantized_inputs(gen, nq, 64, 1024, 1024,
                                             torch.int8)
    for k in (1, 10, 40, 128):
        d, i = ops.quantized_query_topk(q, codes, scale, ids, k, p=p)
        dp, ip = ref.quantized_topk_ref(q, codes, scale, ids, k, p=p)
        _assert_topk_matches(d, i, dp, ip, exact=True)


@pytest.mark.parametrize("p", [2.0, 1.0, 1.5])
def test_rerank_kernel(gen, p):
    q = torch.randn((128, 64), generator=gen).cuda()
    emb = torch.randn((128, 40, 64), generator=gen).cuda()
    ids = torch.randint(-1, 500, (128, 40), generator=gen,
                        dtype=torch.int32).cuda()
    before = dispatch.launches["rerank"]
    d = ops.candidate_distances(q, emb, ids, p=p)
    assert dispatch.launches["rerank"] == before + 1
    want = ref.rerank_ref(q, emb, ids, p)
    assert torch.equal(torch.isinf(d), ids < 0)
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [3, 48, 64, 100, 200])
@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
def test_rerank_kernel_shapes(gen, p, n, offset):
    """K6 at widths on both instantiations (16-byte loads at N % 4 == 0 on
    aligned views, scalar otherwise), with an all-invalid row: rtol 1e-5
    atol 1e-6 of the plain version, +inf exactly where the id is < 0."""
    from repro_torch.kernels import rerank
    b, c = 9, 40
    q = _on_card(torch.randn((b, n), generator=gen), offset)
    emb = _on_card(torch.randn((b, c, n), generator=gen), offset)
    ids = torch.randint(-1, 500, (b, c), generator=gen, dtype=torch.int32)
    ids[2] = -1
    ids = ids.cuda()
    vec = (q.data_ptr() | emb.data_ptr()) % 16 == 0
    assert rerank.plan(b, n, vec).vec == (offset == 0 and n % 4 == 0)
    d = ops.candidate_distances(q, emb, ids, p=p)
    want = ref.rerank_ref(q, emb, ids, p)
    assert torch.equal(torch.isinf(d), ids < 0)
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,k", [(512, 64, 1024), (37, 50, 96)])
def test_simhash_pack_kernel(gen, m, n, k):
    x = torch.randn((m, n), generator=gen).cuda()
    a = torch.randn((n, k), generator=gen).cuda()
    x[0] = 0.0                                 # -0.0 and +0.0 set the bit
    before = dispatch.launches["simhash_pack"]
    sig = ops.simhash_signature(x, a)
    assert dispatch.launches["simhash_pack"] == before + 1
    want = ref.simhash_pack_ref(x, a)
    assert sig.shape == (m, k // 32) and sig.dtype == torch.int32
    assert (sig[0] == -1).all()
    shifts = torch.arange(32, device=x.device)
    bits = ((sig[..., None] >> shifts) & 1).reshape(m, k)
    bits_p = ((want[..., None] >> shifts) & 1).reshape(m, k)
    near = (x @ a).abs() < 1e-5
    assert torch.equal(bits[~near], bits_p[~near])


SIMHASH_SHAPES = [(512, 64, 1024), (37, 50, 96), (1, 64, 32),
                  (513, 100, 160), (4096, 200, 2048)]


def _simhash_bits(sig, m, k):
    shifts = torch.arange(32, device=sig.device)
    return ((sig[..., None] >> shifts) & 1).reshape(m, k)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,n,k", SIMHASH_SHAPES)
def test_simhash_pack_kernel_shapes(gen, m, n, k, offset):
    """K7 at the benchmark's shape and the edges, aligned and 1 float past
    alignment (the scalar path): bit-identical to its fmaf chain
    (``ref.simhash_pack_chain_ref``, the arithmetic of the SIMT kernel it
    replaced), bits equal to the plain version's away from |x @ A| <
    1e-5, and a row of +0.0 and one of -0.0 give words of -1."""
    x = torch.randn((m, n), generator=gen)
    x[0] = 0.0
    if m > 1:
        x[1] = -0.0
    x = _on_card(x, offset)
    a = _on_card(torch.randn((n, k), generator=gen), offset)
    before = dispatch.launches["simhash_pack"]
    sig = ops.simhash_signature(x, a)
    assert dispatch.launches["simhash_pack"] == before + 1
    assert sig.shape == (m, k // 32) and sig.dtype == torch.int32
    assert torch.equal(sig, ref.simhash_pack_chain_ref(x, a))
    near = (x.double() @ a.double()).abs() < 1e-5
    bits = _simhash_bits(sig, m, k)
    bits_p = _simhash_bits(ref.simhash_pack_ref(x, a), m, k)
    assert torch.equal(bits[~near], bits_p[~near])
    assert (sig[:min(m, 2)] == -1).all()


def test_simhash_pack_kernel_batch_invariant(gen):
    """The same rows in calls of 1, 37 and 512 rows give equal words."""
    x = torch.randn((512, 64), generator=gen).cuda()
    a = torch.randn((64, 1024), generator=gen).cuda()
    full = ops.simhash_signature(x, a)
    for lo, hi in ((0, 1), (5, 42), (511, 512)):
        assert torch.equal(ops.simhash_signature(x[lo:hi], a), full[lo:hi])


@pytest.mark.parametrize("k", [100, 1024])
def test_simhash_family_on_the_card(gen, k):
    """SimHash on the card (K7) against the same family on the CPU (the
    plain version), 3-D input: bits equal away from |x @ alpha| < 1e-5,
    the pad bits past K clear on both, and Hamming distances equal where
    no bit is near 0."""
    from repro_torch.core.hashes import SimHash
    alpha = torch.randn((64, k), generator=gen)
    x = torch.randn((3, 40, 64), generator=gen)
    fam_c, fam_g = SimHash(alpha=alpha), SimHash(alpha=alpha.cuda())
    before = dispatch.launches["simhash_pack"]
    sig_g = fam_g(x.cuda())
    assert dispatch.launches["simhash_pack"] == before + 1
    sig_c = fam_c(x)
    assert sig_g.shape == sig_c.shape == (3, 40, -(-k // 32))
    near = ((x.double() @ alpha.double()).abs() < 1e-5).reshape(120, k)
    words = sig_c.shape[-1]
    bits_g = _simhash_bits(sig_g.reshape(120, words).cpu(), 120, 32 * words)
    bits_c = _simhash_bits(sig_c.reshape(120, words), 120, 32 * words)
    assert torch.equal(bits_g[:, :k][~near], bits_c[:, :k][~near])
    assert not bits_g[:, k:].any() and not bits_c[:, k:].any()
    ok = ~near.any(dim=1).reshape(3, 40)
    h_g = SimHash.hamming(sig_g[:, :1], sig_g).cpu()
    h_c = SimHash.hamming(sig_c[:, :1], sig_c)
    assert torch.equal(h_g[ok & ok[:, :1]], h_c[ok & ok[:, :1]])


@pytest.mark.parametrize("p", [1.5, 0.5])
def test_lazy_hash_on_the_card(gen, p):
    """``LazyPStableHash`` on its default device (the card, K1) against
    the same hasher on the CPU (the plain version), with Chambers-Mallows-
    Stuck blocks: hashes equal where |proj - round(proj)| > 1e-4 + 1e-6
    (|x| @ |alpha| + |b|), and through one growth of alpha (128 -> 384
    rows) the first rows and earlier hashes unchanged."""
    from repro_torch.core.hashes import LazyPStableHash
    lz_g = LazyPStableHash.create(7, 32, p=p)
    lz_c = LazyPStableHash.create(7, 32, p=p, device="cpu")
    assert lz_g.b.is_cuda and lz_g.coeffs.device.type == "cuda"
    g = torch.randn((24, 300), generator=gen) * 0.5
    before = dispatch.launches["hash_mm"]
    h100 = lz_g(g[:, :100].cuda())
    assert dispatch.launches["hash_mm"] == before + 1
    first = lz_g.coeffs.alpha(128).clone()
    h300 = lz_g(g.cuda())
    assert lz_g.coeffs.current_n == 384
    assert torch.equal(lz_g.coeffs.alpha(128), first)
    assert torch.equal(lz_g(g[:, :100].cuda()), h100)
    for n_f, h in ((100, h100), (300, h300)):
        alpha = lz_c.coeffs.alpha(n_f)
        _, pp = ref.hash_mm_proj_ref(g[:, :n_f], alpha, lz_c.b, lz_c.r)
        terms = g[:, :n_f].abs() @ alpha.abs() + lz_c.b.abs()
        safe = (pp - torch.round(pp)).abs() > 1e-4 + 1e-6 * terms
        assert torch.equal(h.cpu()[safe], lz_c(g[:, :n_f])[safe])


FP32_PATH = ("hash_mm", "dct_mm", "fused_query", "merge")
INT8_PATH = FP32_PATH + ("quantized_query", "rerank")


def test_serve_path_runs_on_the_card(gen):
    from repro_torch.launch import serve
    dispatch.reset_launches()
    rep = serve.run(device="cuda", tenants=("l2-basis",), n_items=4096,
                    steps=2, recall_probe_size=8,
                    log=lambda *a: None)["l2-basis"]
    assert all(rep["launches"][k] > 0 for k in FP32_PATH)
    assert rep["self_hit_rate"] >= 0.95


def test_int8_serve_path_runs_on_the_card(gen):
    from repro_torch.launch import serve
    dispatch.reset_launches()
    rep = serve.run(device="cuda", tenants=("l2-basis",), n_items=4096,
                    steps=2, recall_probe_size=8, precision="int8",
                    log=lambda *a: None)["l2-basis"]
    assert all(rep["launches"][k] > 0 for k in INT8_PATH)
    assert rep["self_hit_rate"] >= 0.95
    assert rep["store_bytes_per_item"] <= 256 / 3


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n_seg,nq", [(3, 32), (258, 32), (66, 128)])
def test_quantized_query_kernel_per_segment_scale(gen, dtype, n_seg, nq):
    """One K5 launch over n_seg segments, one scale each: equal to the
    plain version with the (S,) scale (bit for bit at int8), and each
    segment's block of rows bit-identical to that segment's own launch."""
    from repro_torch.core import index as lidx
    from repro_torch.kernels import quantize
    cap, c, k = 1024, 1024, 40
    tier = "int8" if dtype == torch.int8 else "bf16"
    codes, scales = [], []
    for s in range(n_seg):
        cd, sc = quantize.encode(
            torch.randn((cap, 64), generator=gen).cuda() * (1 + s % 5), tier)
        codes.append(cd)
        scales.append(sc)
    q = torch.randn((nq, 64), generator=gen).cuda()
    ids = torch.randint(-1, cap, (n_seg, nq, c), generator=gen,
                        dtype=torch.int32).cuda()
    ids[ids % 4 != 0] = -1                 # ~1/4 of the slots valid
    rows = lidx.flat_rows(ids, cap)
    codes_all, scale_all = torch.cat(codes), torch.stack(scales)
    q_rep = q.repeat(n_seg, 1)
    before = dispatch.launches["quantized_query"]
    d, i = ops.quantized_query_topk(q_rep, codes_all, scale_all, rows, k)
    assert dispatch.launches["quantized_query"] == before + 1
    dp, ip = ref.quantized_topk_ref(q_rep, codes_all, scale_all, rows, k)
    _assert_topk_matches(d, i, dp, ip, exact=dtype == torch.int8)
    for s in sorted({0, n_seg // 2, n_seg - 1}):
        ds, is_ = ops.quantized_query_topk(q, codes[s], scales[s],
                                           ids[s].contiguous(), k)
        blk = slice(s * nq, (s + 1) * nq)
        assert torch.equal(d[blk].view(torch.int32), ds.view(torch.int32))
        assert torch.equal(i[blk], torch.where(is_ >= 0, is_ + s * cap, -1))


@pytest.mark.parametrize("precision", ["fp32", "int8", "bf16"])
def test_stacked_query_bit_equal_to_fanout_on_the_card(gen, precision):
    """The stacked query against the per-segment fan-out on the card, bit
    for bit, with deletes in sealed segments and the delta and one sealed
    segment fully tombstoned; K1 launched once a batch, K2 + K5 twice."""
    import numpy as np
    from repro_torch.core import index as lidx
    from repro_torch.serve import SegmentedIndex
    cfg = lidx.IndexConfig(n_dims=64, n_tables=8, n_hashes=4,
                           log2_buckets=10, bucket_capacity=32, r=4.0)
    si = SegmentedIndex(cfg, segment_capacity=1024, device="cuda",
                        precision=precision)
    rng = np.random.default_rng(3)
    emb = (rng.normal(size=(9 * 1024 + 300, 64)) * 0.3).astype(np.float32)
    si.insert(emb)
    si.delete(np.r_[np.arange(0, len(emb), 7), np.arange(2048, 3072)])
    q = emb[rng.integers(0, len(emb), 32)] + 0.01
    dispatch.reset_launches()
    got = si.query(q, 10, n_probes=4)
    counts = dict(dispatch.launches)
    want = si._query_fanout(q, 10, n_probes=4)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert counts["hash_mm"] == 1
    assert counts["fused_query"] + counts["quantized_query"] == 2


@pytest.mark.parametrize("rows", [32, 128])
def test_staged_query_bit_equal_on_the_card(gen, rows):
    """The deep-traced staged query (a span and a device sync per stage)
    against the untraced query on the card, bit for bit, with the same
    launches: K1 once, K2 twice, K3 once; its five stage spans nest in
    the request (no duration asserted here)."""
    import numpy as np
    from repro_torch.core import index as lidx
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import SegmentedIndex
    cfg = lidx.IndexConfig(n_dims=64, n_tables=8, n_hashes=4,
                           log2_buckets=10, bucket_capacity=32, r=4.0)
    si = SegmentedIndex(cfg, segment_capacity=1024, device="cuda",
                        tenant="cuda-staged")
    rng = np.random.default_rng(4)
    emb = (rng.normal(size=(6 * 1024 + 300, 64)) * 0.3).astype(np.float32)
    si.insert(emb)
    si.delete(np.arange(0, len(emb), 5))
    q = emb[rng.integers(0, len(emb), rows)] + 0.01
    want = si.query(q, 10, n_probes=4)
    tr = obs_trace.tracer()
    tr.drain()
    try:
        obs_trace.configure(sample_rate=1.0, deep=True)
        dispatch.reset_launches()
        with tr.span("request", tenant="cuda-staged"):
            got = si.query(q, 10, n_probes=4)
        counts = dict(dispatch.launches)
    finally:
        obs_trace.configure(sample_rate=0.0, deep=False)
        spans = tr.drain()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert (counts["hash_mm"], counts["fused_query"], counts["merge"]) == (
        1, 2, 1)
    names = [s["name"] for s in spans]
    assert names == ["hash", "probe", "gather", "rerank", "merge", "request"]
    root = spans[-1]["span_id"]
    assert all(s["parent_id"] == root for s in spans[:-1])


def test_query_index_batched_on_the_card(gen):
    """5,000 rows in 1,024-row chunks on one 1,024-item segment: bit-equal
    to one query_index call, and to the plain path on the CPU in every row
    no bucket boundary explains (|proj - round(proj)| <= 1e-4 for the row
    or for an id that differs): ids equal where distances are distinct,
    distances rtol 1e-5 atol 1e-6."""
    from repro_torch.core import index as lidx
    cfg = lidx.IndexConfig(n_dims=64, n_tables=8, n_hashes=4,
                           log2_buckets=10, bucket_capacity=32, r=4.0)
    x = torch.randn((1024, 64), generator=gen) * 0.3
    q = x[torch.randint(0, 1024, (5000,), generator=gen)] + 0.01 * \
        torch.randn((5000, 64), generator=gen)
    fam = lidx.make_family(gen, cfg)
    st = lidx.build_index(lidx.create_index(cfg, 1024, family=fam,
                                            device="cuda"), cfg, x.cuda())
    dispatch.reset_launches()
    bi, bd = lidx.query_index_batched(st, cfg, q, 10, n_probes=4,
                                      batch_size=1024)
    assert dispatch.launches["hash_mm"] == 5
    assert dispatch.launches["fused_query"] == 5
    oi, od = lidx.query_index(st, cfg, q, 10, n_probes=4)
    assert torch.equal(bi, oi)
    assert torch.equal(bd.view(torch.int32), od.view(torch.int32))
    st_c = lidx.build_index(lidx.create_index(cfg, 1024, family=fam,
                                              device="cpu"), cfg, x)
    pi, pd = lidx.query_index(st_c, cfg, q, 10, n_probes=4)

    def near(v):
        p = ref.hash_mm_proj_ref(v, fam[0], fam[1], cfg.r)[1]
        return ((p - torch.round(p)).abs() <= 1e-4).any(dim=-1)
    near_item = near(x)
    bi, bd = bi.cpu(), bd.cpu()
    ok = ~near(q)
    for r in torch.nonzero((bi != pi).any(dim=1)).flatten().tolist():
        diff = set(bi[r].tolist()) ^ set(pi[r].tolist())
        if any(i >= 0 and bool(near_item[i]) for i in diff):
            ok[r] = False
    _assert_topk_matches(bd[ok], bi[ok], pd[ok], pi[ok], exact=False)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_wire_answers_bit_equal_on_the_card(gen, precision):
    """The network front-end in this process over a registry on the card:
    16 connections' wire answers (gids and distance bits) equal the direct
    query of the same rows, NaN rows answer (-1, +inf), and the embed verb
    equals ``Servable.embed``; every kernel of the tier's path launched."""
    import threading

    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import BackgroundServer, ServableRegistry
    reg = ServableRegistry(device="cuda")
    serve.run(registry=reg, tenants=("l2-basis",), n_items=4096, steps=1,
              recall_probe_size=8, precision=precision, log=lambda *a: None)
    sv = reg.get("l2-basis")
    rng = np.random.default_rng(3)
    rows = [sv.embed(serve.sample_fvals(rng, sv.nodes(), 8)).cpu().numpy()
            for _ in range(16)]
    got = {}
    with BackgroundServer(reg, metrics=obs_metrics.MetricsRegistry(),
                          maint_workers=1, drain_timeout_s=5.0,
                          timeout_s=60.0) as srv:
        dispatch.reset_launches()

        def stream(i):
            with srv.client() as c:
                got[i] = c.query_arrays("l2-basis", rows[i], k=10,
                                        n_probes=4)
        ts = [threading.Thread(target=stream, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        with srv.client() as c:
            nan = rows[0].copy()
            nan[1, 0] = np.nan
            g, d = c.query_arrays("l2-basis", nan, k=10, n_probes=4)
            assert (g[1] == -1).all() and np.isposinf(d[1]).all()
            fv = serve.sample_fvals(rng, sv.nodes(), 5)
            assert np.array_equal(c.embed("l2-basis", fv),
                                  sv.embed(fv.astype(np.float64))
                                  .cpu().numpy())
        torch.cuda.synchronize()
        path = INT8_PATH if precision == "int8" else FP32_PATH
        assert all(dispatch.launches[k] > 0 for k in path)
    assert len(got) == 16
    for i, (g, d) in got.items():
        # the direct call: the stacked query (int8: and its rescore)
        wg, wd = sv.index.query(rows[i], 10, 4)
        assert np.array_equal(g, wg.cpu().numpy())
        assert np.array_equal(d.view(np.int32),
                              wd.cpu().numpy().view(np.int32))
