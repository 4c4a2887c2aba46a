"""Property tests for the port's admission invariants.

Mirrors ``tests/test_frontend_properties.py`` for ``repro_torch``:
hypothesis drives random interleavings of admit / settle / drain events
against a :class:`RequestGate` (and a gate + sim-clock
:class:`MicroBatcher` pair) and checks after every step that
``inflight == admitted - settled``, ``inflight <= max_inflight``, every
attempt is counted once, every accepted request is answered, a rejected
one is never queued, and nothing is admitted once the process drains.
A third property runs each random interleaving through the JAX package's
gate too and requires the same outcome at every step.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
from _hypothesis_support import given, settings, st  # noqa: E402

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import MicroBatcher  # noqa: E402
from repro_torch.serve import frontend as tfe  # noqa: E402
from repro_torch.serve.frontend import (READY, Admission,  # noqa: E402
                                        Rejection, RequestGate)

N_DIMS = 4
TENANTS = ("a", "b")

# one gate event: (kind, tenant_index, magnitude)
_EVENTS = st.lists(
    st.tuples(
        st.sampled_from(["admit", "settle", "process_drain", "advance"]),
        st.integers(0, len(TENANTS) - 1),
        st.integers(0, 30)),
    min_size=1, max_size=60)


class _ListClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@settings(max_examples=60, deadline=None)
@given(events=_EVENTS, max_inflight=st.integers(1, 4))
def test_gate_ledger_invariants(events, max_inflight):
    clk = _ListClock()
    g = RequestGate(max_inflight=max_inflight, queue_depth=8, clock=clk,
                    metrics=obs_metrics.MetricsRegistry())
    for t in TENANTS:
        g.set_state(t, READY)
    open_toks = {t: [] for t in TENANTS}
    attempts = {t: 0 for t in TENANTS}
    drained = False

    def check():
        for t in TENANTS:
            inflight = g.inflight(t)
            assert inflight == g.admitted[t] - g.settled[t]
            assert 0 <= inflight <= max_inflight
            assert g.admitted[t] + g.rejected[t] == attempts[t]

    for kind, ti, mag in events:
        t = TENANTS[ti]
        if kind == "admit":
            attempts[t] += 1
            out = g.admit(t, rows=1 + mag % 4,
                          timeout_ms=None if mag % 3 else 50.0)
            if isinstance(out, Admission):
                assert not drained, "admitted after process drain"
                open_toks[t].append(out)
            else:
                assert isinstance(out, Rejection)
                assert out.code in ("overloaded", "shutting_down")
        elif kind == "settle" and open_toks[t]:
            g.settle(open_toks[t].pop(mag % len(open_toks[t])))
        elif kind == "process_drain":
            g.begin_drain()
            drained = True
        elif kind == "advance":
            clk.t += mag / 1e3
        check()

    for t in TENANTS:
        for tok in open_toks[t]:
            assert g.settle(tok, drained=drained) in (
                "ok", "deadline_expired")
        assert g.inflight(t) == 0
        assert g.admitted[t] == g.settled[t]


@settings(max_examples=40, deadline=None)
@given(steps=st.lists(
    st.tuples(st.integers(1, 6),       # rows in the request
              st.booleans()),          # pump (past the deadline) after?
    min_size=1, max_size=25))
def test_accepted_answered_rejected_never_enqueued(steps):
    clk = _ListClock()
    g = RequestGate(max_inflight=3, queue_depth=4, clock=clk,
                    metrics=obs_metrics.MetricsRegistry())
    g.set_state("t", READY)

    def qfn(buf, k, n_probes):
        ids = np.tile(np.arange(k, dtype=np.int32), (buf.shape[0], 1))
        return ids, ids.astype(np.float32)

    b = MicroBatcher(qfn, chunk_sizes=(4, 8), max_delay_ms=5.0, clock=clk,
                     metrics=obs_metrics.MetricsRegistry())
    accepted = []                        # (token, future, rows)
    n_submitted = 0
    rng = np.random.default_rng(0)

    for rows, pump in steps:
        out = g.admit("t", rows=rows, queue_depth=b.pending())
        if isinstance(out, Admission):
            fut = b.submit(rng.normal(size=(rows, N_DIMS)).astype(
                np.float32), 2)
            n_submitted += 1
            accepted.append((out, fut, rows))
        assert b.n_requests == n_submitted
        if pump:
            clk.t += 0.006
            b.pump()
            for tok, fut, _ in accepted:
                if fut.done() and not tok.settled:
                    g.settle(tok)
        assert g.inflight("t") == len(
            [1 for tok, _f, _r in accepted if not tok.settled])

    b.flush_all()
    for tok, fut, rows in accepted:
        ids, dists = fut.result(timeout=5)
        assert ids.shape == (rows, 2) and dists.shape == (rows, 2)
        if not tok.settled:
            g.settle(tok, drained=True)
    assert g.inflight("t") == 0
    assert g.totals()["admitted"] == g.totals()["settled"] == len(accepted)
    assert set(c for c, _k, _p in b.shape_counts) <= {4, 8}


_MIXED = st.lists(
    st.tuples(
        st.sampled_from(["admit", "settle", "state", "process_drain",
                         "advance"]),
        st.integers(0, len(TENANTS)),          # the last one is unknown
        st.integers(0, 40)),
    min_size=1, max_size=50)
_STATES = (tfe.LOADING, tfe.READY, tfe.DRAINING, tfe.UNLOADED)


@settings(max_examples=60, deadline=None)
@given(events=_MIXED, max_inflight=st.integers(1, 3),
       queue_depth=st.integers(1, 5))
def test_random_events_answer_as_the_jax_gate(events, max_inflight,
                                              queue_depth):
    def run(fe_mod, metrics_mod):
        clk = _ListClock()
        g = fe_mod.RequestGate(max_inflight=max_inflight,
                               queue_depth=queue_depth, clock=clk,
                               metrics=metrics_mod.MetricsRegistry())
        g.set_state("a", fe_mod.READY)
        toks, out = [], []
        names = TENANTS + ("zz",)
        for kind, ti, mag in events:
            t = names[ti]
            if kind == "admit":
                r = g.admit(t, rows=1 + mag % 3, queue_depth=mag % 7,
                            timeout_ms=(None, 2.0, 0.0)[mag % 3])
                if isinstance(r, fe_mod.Admission):
                    toks.append(r)
                    out.append(("admit", r.deadline))
                else:
                    out.append(("reject", r.code, r.retry_after_ms,
                                r.response(mag)))
            elif kind == "settle" and toks:
                out.append(("settle", g.settle(toks.pop(mag % len(toks)),
                                               drained=bool(mag % 2))))
            elif kind == "state":
                g.set_state(t, _STATES[mag % 4])
            elif kind == "process_drain":
                g.begin_drain()
            elif kind == "advance":
                clk.t += mag / 1e3
            out.append((g.states(), g.totals(), g.total_inflight()))
        return out
    assert run(tfe, obs_metrics) == run(jfe, jmetrics)
