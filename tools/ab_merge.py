#!/usr/bin/env python3
"""K3's select route of this checkout against another checkout's, in
alternating turns in one process on one CUDA card.

    python3 tools/ab_merge.py --parent DIR [--rounds 8] [--variants]

Builds ``csrc/merge.cu`` of this checkout and of the checkout at DIR
(both must have the select route's ``merge_select_launch``) under
``build/ab_merge/``, and times ``ops.merge_topk``'s launch of each
(``mask_invalid``, the plan of ``kernels/merge.plan``, outputs
preallocated) at the four shapes the smoke times: the fp32 fan-in (32,
2570) -> 10, the int8 fan-in (128, 10320) -> 40, 1,032 int8 segments
(128, 41280) -> 40 and the survivor sort (128, 40) -> 10 (a random pool
of that shape), and the two fan-ins again with one pair a row at
distance 0 (an exact match).  Each round times DIR's kernel, then this
checkout's
(``chip_smoke.time_ms``: 50 calls in a CUDA graph, the median of 10
replays), then the same in reverse.  ``--variants`` adds, between them in
each round, DIR's kernel built a second time (a control of the harness)
and copies of this checkout's changed by the text patches in
``VARIANTS``.  Prints one JSON line per shape: every reading in µs, the
medians, each kernel's quartile spread, and whether every kernel's
outputs are bit-identical to DIR's on the shape's input.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, dispatch, merge  # noqa: E402

OUT = ROOT / "build" / "ab_merge"
SHAPES = ((32, 257, 10), (128, 258, 40), (128, 1032, 40), (128, 4, 10))
# the fan-ins again with one exact match a row (a +0.0 distance, as a
# query that equals a stored item gives): the cost of a picked zero
EXACT = ((32, 257, 10), (128, 258, 40))
RESTORE_1 = ("    if (may_hold_zero(win[0])) "
             "restore_negative_zeros(a, row0, out0);\n")
RESTORE_G = "  if (zero) restore_negative_zeros(a, row0, out0);\n"
PUSH_FLAG = ("    if (nb && may_hold_zero(win[0])) {\n"
             "      atomicOr(cluster.map_shared_rank(&s.zero, 0), 1);\n"
             "    }\n")
HEADS_GATE = ("  unsigned long long smallest = kNone;   // the lists' heads\n"
              "  for (int r = 0; r < a.cluster; ++r) {\n"
              "    if (s.counts[r]) "
              "smallest = min(smallest, lists[r * kMaxK]);\n"
              "  }\n  if (may_hold_zero(smallest)) "
              "restore_negative_zeros(a, row0, out0);\n")
SCAN = """  float z = d;
  if (d == 0.0f) {
    const long long row0 = static_cast<long long>(blockIdx.x / a.cluster) *
                           a.m + a.off;
    bool neg = false;
#pragma unroll 8
    for (int j = 0; j < a.m; ++j) {
      neg |= (__float_as_uint(__ldg(a.d + row0 + j)) == 0x80000000u) &
             (__ldg(a.ids + row0 + j) == id);
    }
    if (neg) z = -0.0f;
  }
  a.out_d[at] = z;
"""
VARIANTS = {
    # the -0.0 sign restore left out (gates, flag and pass): its cost
    "no_restore": [(RESTORE_1, ""), (RESTORE_G, ""), (PUSH_FLAG, "")],
    # the cluster's gate read from the G list heads after the merge, not
    # from a flag the ranks set at the push
    "heads_gate": [(PUSH_FLAG, ""), (RESTORE_G, HEADS_GATE)],
    # no gate and no pass: the thread that writes a zero reads the row
    # for its sign (independent loads, no early exit)
    "thread_scan": [(RESTORE_1, ""), (RESTORE_G, ""), (PUSH_FLAG, ""),
                    ("  a.out_d[at] = d;\n", SCAN)],
}


def variant(name: str) -> Path:
    """A copy of this checkout's csrc/ with ``VARIANTS[name]`` applied to
    merge.cu, each (old, new) found once."""
    dst = OUT / name
    dst.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            text = p.read_text()
            if p.name == "merge.cu":
                for old, new in VARIANTS[name]:
                    if text.count(old) != 1:
                        raise RuntimeError(f"merge.cu: expected one {old!r}")
                    text = text.replace(old, new)
            (dst / p.name).write_text(text)
    return dst


def build(csrc: Path, name: str):
    """``csrc/merge.cu`` of one checkout as a library; its select launch."""
    out = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
           str(out), str(csrc / "merge.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out)).merge_select_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def caller(fn, d, i, n_out):
    """One launch of ``fn`` as ops.merge_topk makes it, and its outputs."""
    rows, m = d.shape
    pl = merge.plan(rows, m)
    od = d.new_empty((rows, n_out))
    oi = i.new_empty((rows, n_out))

    def call():
        code = fn(d.data_ptr(), i.data_ptr(), rows, m, n_out, pl.cluster,
                  pl.share, pl.tile, int(pl.vec), 1, od.data_ptr(),
                  oi.data_ptr(), dispatch.stream_handle(d))
        if code:
            raise RuntimeError(f"merge_select_launch: CUDA error {code}")
    return call, (od, oi)


def spread(xs):
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--variants", action="store_true",
                    help="also DIR's kernel built twice and the VARIANTS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_merge: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    pcsrc = args.parent / "src" / "repro_torch" / "csrc"
    fns = {"parent": build(pcsrc, "parent")}
    if args.variants:
        fns["parent_again"] = build(pcsrc, "parent_again")
        for name in VARIANTS:
            fns[name] = build(variant(name), name)
    fns["this"] = build(_build.CSRC, "this")
    turn = list(fns) + list(fns)[::-1]
    gen = torch.Generator().manual_seed(0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for rows, runs, k, exact in ([s + (False,) for s in SHAPES]
                                 + [s + (True,) for s in EXACT]):
        d, i = chip_smoke._fan_in(gen, rows, runs, k)
        if exact:
            d[:, 0] = 0.0
        calls = {who: caller(fn, d, i, k) for who, fn in fns.items()}
        for call, _ in calls.values():
            call()
        torch.cuda.synchronize()
        same = all(torch.equal(calls["parent"][1][t].view(torch.int32),
                               calls[who][1][t].view(torch.int32))
                   for t in (0, 1) for who in fns)
        us = {who: [] for who in fns}
        for _ in range(args.rounds):
            for who in turn:
                us[who].append(1e3 * chip_smoke.time_ms(calls[who][0]))
        print(json.dumps({
            "shape": f"({rows}, {runs * k}) -> {k}"
                     + (", an exact match a row" if exact else ""),
            "bit_identical": same,
            "median_us": {w: statistics.median(x) for w, x in us.items()},
            "iqr_us": {w: spread(x) for w, x in us.items()},
            "us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
