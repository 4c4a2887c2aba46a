"""Render the dry run's cells (``launch/dryrun.py``'s JSON) as a table.

The port of ``repro/launch/report.py``: one row a cell, the three terms of
the roofline, the bottleneck, the bound on MFU, and the memory of a rank
against the card's 80 GB -- the blocks it holds between steps (params,
AdamW moments, gradient, cache), and a step's peak on the device that
computes a data rank (the blocks, the gathered parameters and gradient,
the activations kept).

    python -m repro_torch.launch.report --json build/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

GB = 1e9

HEADER = ("| cell | t_compute (s) | t_memory (s) | t_collective (s) | "
          "bottleneck | mfu_bound | params / moments / cache a rank (GB) | "
          "state (GB) | step peak (GB) | fits 80 GB |")


def fmt_cell(key: str, res: Dict) -> str:
    if res["status"] == "skipped":
        return f"| {key} | skipped | | | | | | | | {res['reason'][:40]} |"
    if res["status"] != "ok":
        return f"| {key} | ERROR | | | | | | | | {res.get('error', '')[:60]} |"
    r = res["roofline"]
    mem = r["memory_stats"]
    per = res["per_rank"]
    fits = ("yes" if res["fits"] else
            "state only" if res["fits_state"] else "no")
    return ("| {k} | {tc:.4f} | {tm:.4f} | {tl:.4f} | {bn} | {mfu:.3f} | "
            "{p:.2f} / {m:.2f} / {c:.2f} | {st:.1f} | {pk:.1f} | {fits} |"
            .format(k=key, tc=r["t_compute"], tm=r["t_memory"],
                    tl=r["t_collective"], bn=r["bottleneck"],
                    mfu=r["mfu_bound"], p=per["param_bytes"] / GB,
                    m=per["moment_bytes"] / GB, c=per["cache_bytes"] / GB,
                    st=mem["state_bytes"] / GB, pk=mem["peak_bytes"] / GB,
                    fits=fits))


def table(results: Dict[str, Dict], mesh: Optional[str] = None
          ) -> List[str]:
    """The table's lines (cells whose key starts with ``mesh``, if
    given)."""
    lines = [HEADER, "|" + "---|" * (HEADER.count("|") - 1)]
    for key in sorted(results):
        if mesh and not key.startswith(mesh + "/"):
            continue
        lines.append(fmt_cell(key, results[key]))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=os.path.join("build",
                                                   "dryrun_torch.json"))
    ap.add_argument("--mesh", default=None,
                    help="only the cells of this mesh (single, or DxM)")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    for line in table(results, args.mesh):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
