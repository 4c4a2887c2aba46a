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
