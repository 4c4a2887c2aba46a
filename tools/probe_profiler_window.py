#!/usr/bin/env python3
"""Which kernel records does torch.profiler lose as a process ages?  On one
CUDA card:

    python3 tools/probe_profiler_window.py [--seconds 330] [--prefix 0 256]
        [--pad 0 0.1] [--helper]

Every round (``--every`` seconds of busy card apart) it opens one profiled
window per (``--prefix``, ``--pad``) pair: ``prefix`` launches of a
one-element multiply, a synchronize, ``pad`` seconds of idle card, 50
launches of a 65,536-element add (the work), a synchronize, ``pad`` seconds
again.  It prints one JSON line a window: the work's kernel records (50 if
none was lost), the prefix's, and the first positions among the 50 work
launches whose kernel record is missing (their launch records are there).
With ``--helper`` each round also profiles the 50 launches in one window
of ``repro_torch.launch.profiled`` (its prefix and span: kernels, and
launch records in the span without a kernel record) and counts them
through its ``card_kernels`` (which must say 50).
``chip_smoke.kernels_in`` and ``launch/lsh_cell.py`` count through that
helper because of what this shows (PERF.md, phase 12).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def window(x, z, prefix: int, pad: float, path: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prefix):
            z.mul_(1)
        torch.cuda.synchronize()
        time.sleep(pad)
        for _ in range(50):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad)
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    os.unlink(path)
    launches = sorted((e["ts"], e["args"].get("correlation")) for e in ev
                      if e.get("cat") == "cuda_runtime"
                      and "Launch" in e.get("name", ""))
    kern = {e["args"].get("correlation") for e in ev
            if e.get("cat") == "kernel"}
    pre, work = launches[:prefix], launches[prefix:]
    return {"launch_records": len(launches),
            "prefix_kernels": sum(c in kern for _, c in pre),
            "work_kernels": sum(c in kern for _, c in work),
            "work_missing_at": [i for i, (_, c) in enumerate(work)
                                if c not in kern][:4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=330.0)
    ap.add_argument("--every", type=float, default=20.0,
                    help="seconds of busy card between rounds")
    ap.add_argument("--prefix", type=int, nargs="+", default=[0, 256],
                    help="launches before the work in a window")
    ap.add_argument("--pad", type=float, nargs="+", default=[0.0],
                    help="idle seconds each side of the work")
    ap.add_argument("--helper", action="store_true",
                    help="also count the work through profiled.card_kernels")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.launch import profiled
    warnings.simplefilter("ignore")
    dev = torch.device("cuda:0")
    x = torch.zeros(1 << 16, device=dev)
    z = torch.zeros(1, device=dev)
    path = os.path.join(tempfile.mkdtemp(), "window.json")

    def work():
        for _ in range(50):
            x.add_(1)
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        for prefix in args.prefix:
            for pad in args.pad:
                rec = window(x, z, prefix, pad, path)
                print(json.dumps({"t_s": round(time.time() - t0, 1),
                                  "prefix": prefix, "pad_s": pad, **rec}),
                      flush=True)
        if args.helper:
            one = profiled.window(work, dev)
            print(json.dumps({"t_s": round(time.time() - t0, 1),
                              "helper_window": {"kernels": one[0],
                                                "records_lost": one[1]},
                              "helper_kernels": profiled.card_kernels(
                                  work, dev)}), flush=True)
        t1 = time.time()
        while time.time() - t1 < args.every:
            for _ in range(200):
                x.add_(1)
            torch.cuda.synchronize()
    os.rmdir(os.path.dirname(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
