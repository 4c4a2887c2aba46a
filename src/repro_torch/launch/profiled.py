"""Count every kernel the card runs in a call, from torch.profiler's trace,
and only from a window that lost none.

The profiler loses kernel records at the start of a window, and loses more
the older the process is: the first launch of a window after 30 s of
process, the first 20 after 5 minutes, while their launch records stay in
the trace (PERF.md, phase 12; ``tools/probe_profiler_window.py``).  Now
and then it also drops a longer run of kernel records anywhere in the
window.  So :func:`card_kernels` opens each window with ``PREFIX``
sacrificial ``spin_kernel`` launches (``torch.cuda._sleep``), which take
the first kind of loss, runs the call inside a ``record_function`` span,
and takes the window only if every launch record in that span has its
kernel record; otherwise it profiles the call again.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable

import torch

PREFIX = 256        # sacrificial launches at the start of a window
ATTEMPTS = 5        # windows to try before giving up
SPAN = "card_kernels"


def tally(events: list) -> tuple:
    """(kernels outside the prefix, launch records in the ``SPAN`` span
    that have no kernel record) of a Chrome trace's events; (None, None)
    without exactly one span."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        return None, None
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0].get("dur", 0))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    have = {e.get("args", {}).get("correlation") for e in kernels}
    launched = [e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "")
                and t0 <= float(e["ts"]) <= t1]
    return (sum("spin_kernel" not in e.get("name", "") for e in kernels),
            sum(c not in have for c in launched))


def window(fn: Callable, dev: torch.device) -> tuple:
    """Profile one call of ``fn`` on ``dev``: :func:`tally` of its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.cuda.device(dev):
            for _ in range(PREFIX):
                torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return tally(json.load(f).get("traceEvents", []))


def card_kernels(fn: Callable, dev: torch.device) -> int:
    """Kernels the card runs in one call of ``fn``, from the first of up to
    ``ATTEMPTS`` profiled windows that lost no kernel record (each window
    calls ``fn`` once).  Raises RuntimeError if none was whole."""
    if dev.type != "cuda":
        raise ValueError(f"card_kernels profiles a CUDA device, not {dev}")
    seen = []
    for _ in range(ATTEMPTS):
        n, lost = window(fn, dev)
        if lost == 0:
            return n
        seen.append((n, lost))
    raise RuntimeError(f"no profiled window of {ATTEMPTS} kept every kernel "
                       f"record: (kernels, records lost) {seen}")
