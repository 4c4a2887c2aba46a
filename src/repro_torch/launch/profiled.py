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
kernel record; otherwise it profiles the call again.  :func:`kernel_records`
keeps a whole window likewise and returns the kernel records of the
call's own launches, for their durations.
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


def _span(events: list):
    """(start, end) in µs of the one ``SPAN`` span; None without exactly
    one."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        return None
    t0 = float(span[0]["ts"])
    return t0, t0 + float(span[0].get("dur", 0))


def _launched(events: list, t0: float, t1: float) -> list:
    """Correlation ids of the launch records between ``t0`` and ``t1``."""
    return [e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "Launch" in e.get("name", "")
            and t0 <= float(e["ts"]) <= t1]


def tally(events: list) -> tuple:
    """(kernels outside the prefix, launch records in the ``SPAN`` span
    that have no kernel record) of a Chrome trace's events; (None, None)
    without exactly one span."""
    edges = _span(events)
    if edges is None:
        return None, None
    kernels = [e for e in events if e.get("cat") == "kernel"]
    have = {e.get("args", {}).get("correlation") for e in kernels}
    launched = _launched(events, *edges)
    return (sum("spin_kernel" not in e.get("name", "") for e in kernels),
            sum(c not in have for c in launched))


def span_kernels(events: list) -> tuple:
    """(the kernel records of the launches in the ``SPAN`` span, how many of
    those launches have none, the span's length in µs) of a Chrome trace's
    events; (None, None, None) without exactly one span."""
    edges = _span(events)
    if edges is None:
        return None, None, None
    launched = set(_launched(events, *edges))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched]
    have = {e["args"]["correlation"] for e in kernels}
    return kernels, len(launched - have), edges[1] - edges[0]


def _trace(fn: Callable, dev: torch.device) -> list:
    """The Chrome trace's events of one profiled call of ``fn`` on ``dev``:
    ``PREFIX`` sacrificial launches, then ``fn()`` in the ``SPAN`` span,
    synchronised before the span ends."""
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
            return json.load(f).get("traceEvents", [])


def window(fn: Callable, dev: torch.device) -> tuple:
    """Profile one call of ``fn`` on ``dev``: :func:`tally` of its trace."""
    return tally(_trace(fn, dev))


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


def kernel_records(fn: Callable, dev: torch.device) -> tuple:
    """(the kernel records of one call of ``fn`` on ``dev``, the call's
    length on the host clock in µs, the (kernels, records lost) of the
    windows tried) from the first of up to ``ATTEMPTS`` profiled windows in
    which every launch of the call has its kernel record (each window calls
    ``fn`` once).  The records and the length are None if no window was
    whole."""
    if dev.type != "cuda":
        raise ValueError(f"kernel_records profiles a CUDA device, not {dev}")
    seen = []
    for _ in range(ATTEMPTS):
        kernels, lost, span_us = span_kernels(_trace(fn, dev))
        seen.append((None if kernels is None else len(kernels), lost))
        if lost == 0:
            return kernels, span_us, seen
    return None, None, seen
