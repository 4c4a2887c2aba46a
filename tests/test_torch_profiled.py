"""``repro_torch.launch.profiled``: the kernel count taken only from a
profiled window that lost no kernel record.

The profiler itself needs a card; here its trace is written by hand, so
these tests hold the tally (which kernels count, which launch records must
have a kernel record) and the retry, on the CPU.
"""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.launch import profiled  # noqa: E402


def span(ts, dur):
    return {"name": profiled.SPAN, "cat": "user_annotation", "ts": ts,
            "dur": dur}


def launch(corr, ts, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"name": name, "cat": cat, "ts": ts,
            "args": {"correlation": corr}}


def kernel(corr, name="void at::native::vectorized_elementwise_kernel"):
    return {"name": name, "cat": "kernel", "ts": 0.0,
            "args": {"correlation": corr}}


def prefix(n_kept, n_lost):
    """The window's sacrificial launches at ts 0..; the first ``n_lost``
    kernel records missing, as the profiler loses them."""
    n = n_kept + n_lost
    return ([launch(c, float(c)) for c in range(n)]
            + [kernel(c, "spin_kernel(long)") for c in range(n_lost, n)])


def test_tally_counts_the_call_and_not_the_prefix():
    events = (prefix(250, 6) + [span(1000.0, 500.0)]
              + [launch(1000 + i, 1001.0 + i) for i in range(5)]
              + [kernel(1000 + i) for i in range(5)]
              # a driver-API launch (the port's cluster kernels) and a copy
              + [launch(2000, 1100.0, "cuLaunchKernelEx", "cuda_driver"),
                 kernel(2000, "row_topk_kernel<float, 2>"),
                 {"name": "cudaMemcpyAsync", "cat": "cuda_runtime",
                  "ts": 1200.0, "args": {"correlation": 2001}}])
    assert profiled.tally(events) == (6, 0)


def test_tally_flags_a_launch_in_the_span_without_its_kernel():
    events = (prefix(256, 0) + [span(1000.0, 500.0)]
              + [launch(1000 + i, 1001.0 + i) for i in range(5)]
              + [kernel(1000 + i) for i in (0, 1, 3, 4)])
    assert profiled.tally(events) == (4, 1)
    # a launch after the span ends is not the call's
    late = events + [launch(3000, 1600.0)]
    assert profiled.tally(late) == (4, 1)


def test_tally_without_the_span():
    assert profiled.tally(prefix(3, 0)) == (None, None)
    two = [span(0.0, 1.0), span(5.0, 1.0)]
    assert profiled.tally(two) == (None, None)


def test_card_kernels_retries_until_a_window_is_whole(monkeypatch):
    seen = iter([(290, 18), (None, None), (308, 0), (1, 0)])
    monkeypatch.setattr(profiled, "window", lambda fn, dev: next(seen))
    assert profiled.card_kernels(lambda: None, torch.device("cuda:0")) == 308


def test_card_kernels_gives_up(monkeypatch):
    calls = []
    monkeypatch.setattr(profiled, "window",
                        lambda fn, dev: calls.append(1) or (305, 3))
    monkeypatch.setattr(profiled, "ATTEMPTS", 3)
    with pytest.raises(RuntimeError, match="no profiled window of 3"):
        profiled.card_kernels(lambda: None, torch.device("cuda:0"))
    assert len(calls) == 3


def test_card_kernels_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        profiled.card_kernels(lambda: None, torch.device("cpu"))


def timed(corr, dur, name="void at::native::vectorized_elementwise_kernel"):
    return dict(kernel(corr, name), dur=dur)


def test_span_kernels_keeps_the_calls_kernels_with_their_durations():
    events = (prefix(250, 6) + [span(1000.0, 500.0)]
              + [launch(1000 + i, 1001.0 + i) for i in range(3)]
              + [timed(1000 + i, 2.5 * (i + 1)) for i in range(3)]
              + [launch(2000, 1100.0, "cuLaunchKernelEx", "cuda_driver"),
                 timed(2000, 4.0, "row_topk_kernel<float, 2>")]
              # launched after the span: not the call's
              + [launch(3000, 1600.0), timed(3000, 99.0)])
    kernels, lost, span_us = profiled.span_kernels(events)
    assert lost == 0 and span_us == 500.0
    assert sorted(e["args"]["correlation"] for e in kernels) == [
        1000, 1001, 1002, 2000]
    assert sum(e["dur"] for e in kernels) == 19.0


def test_span_kernels_counts_the_lost_and_needs_one_span():
    events = (prefix(256, 0) + [span(1000.0, 500.0)]
              + [launch(1000 + i, 1001.0 + i) for i in range(5)]
              + [timed(1000 + i, 1.0) for i in (0, 2, 4)])
    kernels, lost, _ = profiled.span_kernels(events)
    assert (len(kernels), lost) == (3, 2)
    assert profiled.span_kernels(prefix(3, 0)) == (None, None, None)


def test_kernel_records_keeps_the_first_whole_window(monkeypatch):
    def trace(n_lost):
        return ([span(0.0, 40.0)] + [launch(i, 1.0 + i) for i in range(4)]
                + [timed(i, 2.0) for i in range(n_lost, 4)])
    seen = iter([trace(2), [], trace(0), trace(1)])
    monkeypatch.setattr(profiled, "_trace", lambda fn, dev: next(seen))
    kernels, span_us, tried = profiled.kernel_records(
        lambda: None, torch.device("cuda:0"))
    assert len(kernels) == 4 and span_us == 40.0
    assert tried == [(2, 2), (None, None), (4, 0)]


def test_kernel_records_without_a_whole_window(monkeypatch):
    lossy = [span(0.0, 10.0), launch(1, 1.0), launch(2, 2.0), timed(2, 1.0)]
    monkeypatch.setattr(profiled, "_trace", lambda fn, dev: lossy)
    monkeypatch.setattr(profiled, "ATTEMPTS", 3)
    assert profiled.kernel_records(lambda: None, torch.device("cuda:0")) == (
        None, None, [(1, 1)] * 3)
    with pytest.raises(ValueError, match="CUDA"):
        profiled.kernel_records(lambda: None, torch.device("cpu"))
