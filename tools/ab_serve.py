#!/usr/bin/env python3
"""The serve launcher of this checkout against another checkout's, in
alternating turns on one CUDA card.

    python3 tools/ab_serve.py --parent DIR [--rounds 3] [--precision int8]

Each turn is one fresh process of ``python -m repro_torch.launch.serve
--tenants l2-basis --n-items 262144 --steps 20`` (the smoke's phase 6 or 7
workload) run from a checkout's root with its own ``src`` on the path;
round r runs DIR then this checkout when r is even, the reverse when it is
odd.  Prints the card's ``nvidia-smi`` name and power limit, one JSON line
per turn (p50 / p95 per batch in ms, QPS and fill rate from the
launcher's report) and a last JSON line with each checkout's medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("p50_ms", "p95_ms", "qps", "ingest_rows_per_s")


def turn(root: Path, precision: str, n_items: int, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tenants",
         "l2-basis", "--n-items", str(n_items), "--steps", str(steps),
         "--precision", precision],
        cwd=root, env=env, capture_output=True, text=True, timeout=900,
        check=True).stdout
    line = next(x for x in out.splitlines()
                if x.startswith("[serve] report:"))
    rep = json.loads(line.split(":", 1)[1])["l2-basis"]
    return {k: rep[k] for k in KEYS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--precision", default="int8")
    ap.add_argument("--n-items", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs = {name: [] for name in sides}
    for r in range(args.rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for name in order:
            rec = turn(sides[name], args.precision, args.n_items, args.steps)
            runs[name].append(rec)
            print(json.dumps({"round": r, "side": name,
                              "precision": args.precision, **rec}),
                  flush=True)
    print(json.dumps({name: {k: statistics.median(x[k] for x in recs)
                             for k in KEYS}
                      for name, recs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
