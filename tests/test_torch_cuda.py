"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  On a machine
with the card (and nvcc), run

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's machine
need not have.)

Tolerances as in ``chip_smoke.py``: projections allclose and hashes equal
away from a bucket boundary, embeddings allclose, top-k distances allclose
with ids equal where distances are distinct, the merge bit-identical.
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


def test_serve_path_runs_on_the_card(gen):
    from repro_torch.launch import serve
    dispatch.reset_launches()
    rep = serve.run(device="cuda", n_items=4096, steps=2,
                    recall_probe_size=8, log=lambda *a: None)
    assert all(rep["launches"][k] > 0 for k in dispatch.KERNELS)
    assert rep["self_hit_rate"] >= 0.95
