#!/usr/bin/env python3
"""In which order the plain version and K5 sum a bf16 row's squared
differences, on one CUDA card.

    python3 tools/probe_sum_order.py

K5's bf16 distances are held to its plain version,
``ref.quantized_topk_ref`` (``torch.sum`` of the rounded products
``diff * diff`` over the last axis, then ``sqrt``), within rtol 1e-5: the
two sum 64 products in different orders.  This probe names the orders.
For rows of bf16 codes against fp32 queries (the bf16 tier's inputs) it
computes each candidate order's sum explicitly on the card, one fp32
operation at a time, and counts the rows whose ``sqrt`` is bit-equal to
(a) the plain version's distance and (b) K5's.  Candidate orders:

- ``seq``: one chain over t = 0 .. 63 of rounded products;
- ``seq_fma``: one fused multiply-add chain (the fma emulated in float64);
- ``lanes8_fma``: K5's bf16 instantiation at N = 64 -- 8 lanes, lane l an
  fma chain over its 16-byte chunk t = 8l .. 8l+7, then an xor butterfly
  over offsets 4, 2, 1;
- ``vec4_T``: PyTorch's vectorized reduce as it may be configured, T
  threads a row, each summing 4 accumulators (element 4 * (T r + thread) +
  i into accumulator i) of rounded products, the 4 combined in order, then
  a shuffle-down tree over offsets 1, 2, .. T/2 (``_desc``: T/2 .. 1);
- ``stride_T``: the same reduce unvectorized, element thread + T (i + 4 r)
  into accumulator i.

Then it builds a copy of K5 (``quantized_query.cu`` with ``topk.cuh``
text-patched, ``PLAIN_ORDER``) whose bf16 instantiation at N = 64 sums in
the plain version's order: each lane squares its 8 values alone (no fused
multiply-add), the 8 lanes trade halves at lane-xor 4, 2, 1 (the tree's
offsets 32, 16, 8), and a tree at lane-xor 4, 2, 1 finishes (offsets 4,
2, 1).  It counts that copy's bit-equal distances on the same rows and at
the serve path's shapes, and times both builds there as
``chip_smoke.py``'s phase 5 times K5 (``chip_smoke.time_ms``: 50 calls in
a CUDA graph, median of 10 replays): bf16 at 32 and 128 rows, C = 1024
(a quarter valid), k = 40, in the order this, copy, copy, this; int8 as a
control (its code is the same in both builds).

Prints one JSON line of counts and one of times, with the card's name and
power limit.  Run it from the root of the checkout; the copy is built
under ``build/probe_sum_order/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import (_build, dispatch, quantize,  # noqa: E402
                                 quantized_query, ref)
from repro_torch.kernels.fused_query import _plan  # noqa: E402

ROWS, N = 4096, 64
OUT = ROOT / "build" / "probe_sum_order"
# The plain version's order for 8 lanes of 8 consecutive terms (lane l: t =
# 8 l .. 8 l + 7).  PyTorch's tree pairs t with t + 32, then + 16, + 8 (the
# lane's bits, high first), then + 4, + 2, + 1 (the value's).  At lane-xor
# 4 a lane keeps the 4 values whose bit 2 is its own bit 2, sends the
# other 4 and adds its partner's; at 2 and 1 likewise with 2 and 1 values;
# lane l then holds value l summed over the lanes, and lane-xor 4, 2, 1
# finish the tree.  Every add has the operands of PyTorch's add at that
# node.
PLAIN_SUM8 = r"""
__device__ __forceinline__ float plain_order_sum8(const float (&v)[8],
                                                  int sl) {
  const bool b4 = sl & 4, b2 = sl & 2, b1 = sl & 1;
  float h4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? v[i] : v[i + 4];
    h4[i] = __fadd_rn(b4 ? v[i + 4] : v[i],
                      __shfl_xor_sync(0xffffffffu, send, 4));
  }
  float h2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b2 ? h4[i] : h4[i + 2];
    h2[i] = __fadd_rn(b2 ? h4[i + 2] : h4[i],
                      __shfl_xor_sync(0xffffffffu, send, 2));
  }
  float s = __fadd_rn(b1 ? h2[1] : h2[0],
                      __shfl_xor_sync(0xffffffffu, b1 ? h2[0] : h2[1], 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
}

"""
# score()'s bf16 rows at N = 64 (8 lanes, one 16-byte chunk a lane) summed
# in that order; the other types and widths fall through to the chains.
PLAIN_PATH = r"""    if constexpr (kVec && std::is_same_v<T, __nv_bfloat16>) {
      if (a.n == 64) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = e[u] < count
                     ? __ldg(reinterpret_cast<const uint4*>(x[u]) + sl)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
        float qv[8];
        const float4 f0 = reinterpret_cast<const float4*>(sq)[2 * sl];
        const float4 f1 = reinterpret_cast<const float4*>(sq)[2 * sl + 1];
        qv[0] = f0.x; qv[1] = f0.y; qv[2] = f0.z; qv[3] = f0.w;
        qv[4] = f1.x; qv[5] = f1.y; qv[6] = f1.z; qv[7] = f1.w;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float w[8], t8[8];
          Chunk<T>::widen(v[u], w);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float d = w[t] - qv[t];
            t8[t] = kMode == 2 ? __fmul_rn(d, d) : term<kMode>(d, a.p);
          }
          const float s = plain_order_sum8(t8, sl);
          if (e[u] < count && sl == 0) {
            const float dist = finish<kMode>(s, a.p);
            keys[e[u]] =
                (static_cast<unsigned long long>(__float_as_uint(dist))
                 << 32) | slot[u];
          }
        }
        continue;
      }
    }
"""
PLAIN_ORDER = [("// Score the count compacted candidates",
                PLAIN_SUM8 + "// Score the count compacted candidates"),
               ("    if (kVec) {\n", PLAIN_PATH + "    if (kVec) {\n")]


def fma(a, b, c):
    """fp32 fma(a, b, c), emulated: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _combine(acc: torch.Tensor) -> torch.Tensor:
    """(rows, T, 4) accumulators -> (rows, T): ((a0 + a1) + a2) + a3."""
    val = acc[..., 0]
    for i in range(1, 4):
        val = val + acc[..., i]
    return val


def _tree(val: torch.Tensor, name: str) -> dict:
    """Lane 0 of a shuffle-down tree over the T lanes of ``val`` (rows, T),
    offsets ascending (``name``) and descending (``name_desc``)."""
    threads = val.shape[1]
    idx = torch.arange(threads, device=val.device)
    offs = [1 << j for j in range(threads.bit_length() - 1)]
    out = {}
    for desc in (False, True):
        w = val.clone()
        for off in (offs[::-1] if desc else offs):
            inside = idx + off < threads
            w = w + torch.where(inside, w[:, torch.where(inside, idx + off,
                                                         idx)],
                                torch.zeros_like(w))
        out[name + ("_desc" if desc else "")] = w[:, 0]
    return out


def orders(diff: torch.Tensor) -> dict:
    """Each candidate order's sum of squares of ``diff`` (rows, 64) f32."""
    p = diff * diff
    out = {}
    s = torch.zeros_like(p[:, 0])
    for t in range(N):
        s = s + p[:, t]
    out["seq"] = s
    s = torch.zeros_like(p[:, 0])
    for t in range(N):
        s = fma(diff[:, t], diff[:, t], s)
    out["seq_fma"] = s
    lanes = torch.zeros_like(p[:, :8])
    for t in range(8):
        lanes = fma(diff[:, t::8], diff[:, t::8], lanes)
    for off in (4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(8) ^ off]
    out["lanes8_fma"] = lanes[:, 0]
    for threads in (1, 2, 4, 8, 16):
        acc = torch.zeros((p.shape[0], threads, 4), device=p.device)
        v = p.view(p.shape[0], N // (4 * threads), threads, 4)
        for r in range(v.shape[1]):
            acc = acc + v[:, r]
        out.update(_tree(_combine(acc), f"vec4_{threads}"))
    for threads in (8, 16, 32):
        # element tid + T * (i + 4 r) into accumulator i of thread tid
        # (zeros past the row: x + 0 is x)
        acc = torch.zeros((p.shape[0], threads, 4), device=p.device)
        pad = -N % (4 * threads)
        v = torch.nn.functional.pad(p, (0, pad)).view(p.shape[0], -1, 4,
                                                      threads)
        for r in range(v.shape[1]):
            acc = acc + v[:, r].transpose(1, 2)
        out.update(_tree(_combine(acc), f"stride_{threads}"))
    return out


def plain_order_launcher():
    """The K5 copy that sums bf16 rows in the plain order: its launch
    function, with the argument types of the wrapper's."""
    d = OUT / "src"
    d.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "topk.cuh").read_text()
    for old, new in PLAIN_ORDER:
        if text.count(old) != 1:
            raise RuntimeError(f"topk.cuh: expected one {old!r}")
        text = text.replace(old, new)
    (d / "topk.cuh").write_text(text)
    (d / "quantized_query.cu").write_text(
        (_build.CSRC / "quantized_query.cu").read_text())
    so = OUT / "plain_order.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d),
                          "-I", str(_build.CSRC), "-o", str(so),
                          str(d / "quantized_query.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc plain_order:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(so)).quantized_query_launch
    fn.argtypes = quantized_query._launcher()[1].argtypes
    fn.restype = ctypes.c_int
    return fn


def run(fn, q, codes, scale, ids, k, out):
    """One launch of ``fn`` as ``quantized_query_topk`` makes it (p = 2),
    into ``out`` = (dists, ids)."""
    nq, n = q.shape
    plan = _plan(nq, ids.shape[1], n, codes.element_size())
    code = fn(q.data_ptr(), codes.data_ptr(), int(codes.dtype == torch.int8),
              scale.data_ptr(), ids.data_ptr(), nq, n, ids.shape[1], k,
              codes.shape[0], 2, 2.0, plan.cluster, plan.slots,
              plan.lanes.bit_length() - 1, int(plan.vec), out[0].data_ptr(),
              out[1].data_ptr(), dispatch.stream_handle(q))
    if code:
        raise RuntimeError(f"quantized_query launch: CUDA error {code}")
    return out


def path_inputs(nq, precision, seed=0):
    """Phase 5's K5 shape, synthetic: (nq, 64) queries near rows of a
    (4096, 64) table, C = 1024 slots a row with a quarter valid."""
    g = torch.Generator().manual_seed(seed)
    db = torch.randn((4096, N), generator=g)
    q = (db[torch.randint(0, 4096, (nq,), generator=g)]
         + 0.3 * torch.randn((nq, N), generator=g))
    ids = torch.randint(0, 4096, (nq, 1024), generator=g, dtype=torch.int32)
    ids[torch.rand((nq, 1024), generator=g) < 0.75] = -1
    codes, scale = quantize.encode(db.cuda(), precision)
    return q.cuda(), codes, scale, ids.cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sum_order: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    db = torch.randn((ROWS, N), generator=gen)
    q = db + 0.2 * torch.randn((ROWS, N), generator=gen)
    codes, scale = quantize.encode(db.cuda(), "bf16")
    q = q.cuda()
    # one candidate a query: row i against code row i
    ids = torch.arange(ROWS, dtype=torch.int32, device="cuda")[:, None]
    dp, _ = ref.quantized_topk_ref(q, codes, scale, ids, 1)
    dk, _ = quantized_query.quantized_query_topk(q, codes, scale, ids, 1)
    this = quantized_query._launcher()[1]
    copy = plain_order_launcher()

    def outputs(nq, k):
        return (torch.empty((nq, k), device="cuda"),
                torch.empty((nq, k), dtype=torch.int32, device="cuda"))
    do, _ = run(copy, q, codes, scale, ids, 1, outputs(ROWS, 1))
    torch.cuda.synchronize()
    diff = codes.float() - q
    bits = lambda t: t.contiguous().view(torch.int32)
    rec = {"device": smi, "rows": ROWS, "n": N,
           "plain_vs_kernel_bit_equal": int((bits(dp) == bits(dk)).sum()),
           "plain_vs_plain_order_copy_bit_equal":
               int((bits(dp) == bits(do)).sum()),
           "max_rel_diff": float(((dp - dk).abs() / dp.abs()).max())}
    for name, s in orders(diff).items():
        d = torch.sqrt(s)[:, None]
        rec[name] = {"plain": int((bits(d) == bits(dp)).sum()),
                     "kernel": int((bits(d) == bits(dk)).sum())}
    print(json.dumps(rec), flush=True)

    # the serve path's shapes: bit identity with the plain version, times
    times = {"device": smi, "timing": "K5 us per call, this / copy / copy "
             "/ this"}
    for precision in ("bf16", "int8"):
        for nq in (32, 128):
            qq, cc, sc, ii = path_inputs(nq, precision)
            want_d, want_i = ref.quantized_topk_ref(qq, cc, sc, ii, 40)
            got = {}
            for name, fn in (("this", this), ("copy", copy)):
                got[name] = run(fn, qq, cc, sc, ii, 40, outputs(nq, 40))
            torch.cuda.synchronize()
            tag = f"{precision}@{nq}"
            for name, (d, i) in got.items():
                rec_ = {"ids_equal": bool(torch.equal(i, want_i)),
                        "dists_bit_equal": int((bits(d) == bits(want_d))
                                               .sum()),
                        "dists": d.numel()}
                times[f"{tag}_{name}_vs_plain"] = rec_
            us = []
            for name in ("this", "copy", "copy", "this"):
                fn, out = (this if name == "this" else copy), got[name]
                us.append(time_ms(lambda fn=fn, out=out: run(
                    fn, qq, cc, sc, ii, 40, out)) * 1e3)
            times[f"{tag}_us"] = us
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
