"""Serving statistics: QPS, latency percentiles, recall proxy, occupancy.

The port's own copy of ``repro/serve/stats.py``.  Host-side and
lock-guarded: a bounded deque of (t, n) events per rate window and a
bounded latency reservoir for percentiles.  Every record_*
call also publishes into the ``obs.metrics`` registry under the
servable's ``tenant`` label (``serve_queries_total`` and the rest);
:meth:`ServingStats.snapshot` stays the in-process view.
:meth:`ServingStats.record_fanout` takes the merged answer's wins per
segment (``SegmentedIndex.segment_wins``) into
``serve_segment_wins_total`` and, when sharded, its wins per rank into
``serve_device_wins_total`` and a routed batch's instances per rank into
``serve_device_load_total``; it also accumulates them positionally (slot
i = segment or rank i at record time) for :meth:`ServingStats.
shard_balance`, the ``auto`` replication policy's input, which
:meth:`ServingStats.reset_fanout` zeroes at each re-placement.  The recall
proxy
replays a probe set through the segmented index and an exact brute-force
scan over its live items.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import index as lidx
from ..obs import metrics as obs_metrics


def _accumulate(acc: np.ndarray, new) -> np.ndarray:
    """acc += new, acc grown to len(new) (positional, zero-filled)."""
    new = np.asarray(new, np.int64).ravel()
    if new.shape[0] > acc.shape[0]:
        acc = np.concatenate([acc, np.zeros(new.shape[0] - acc.shape[0],
                                            np.int64)])
    acc[:new.shape[0]] += new
    return acc


class ServingStats:
    """Sliding-window rates + latency reservoir for one servable."""

    def __init__(self, *, window_s: float = 10.0, reservoir: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 tenant: str = "default",
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        self.window = window_s
        self.clock = clock
        self.tenant = tenant
        self.metrics = obs_metrics.registry() if metrics is None else metrics
        self._lock = threading.Lock()
        self._queries: deque = deque()       # (t, n_queries)
        self._inserts: deque = deque()
        self._lat = np.zeros((reservoir,), np.float64)
        self._lat_n = 0                      # total recorded (ring index)
        self.totals = {"queries": 0, "inserts": 0, "deletes": 0, "batches": 0,
                       "rejected_inserts": 0}
        self._rows_real = 0
        self._rows_pad = 0
        self._recall: Optional[float] = None
        # fan-out balance: positional counters (see the module docstring)
        self._seg_wins = np.zeros((0,), np.int64)
        self._seg_cands = np.zeros((0,), np.int64)
        self._dev_wins = np.zeros((0,), np.int64)
        self._dev_load = np.zeros((0,), np.int64)
        self._fanout_n = 0

    def _trim(self, dq: deque, now: float) -> None:
        while dq and dq[0][0] < now - self.window:
            dq.popleft()

    def record_query(self, n: int, latency_s: Optional[float] = None) -> None:
        now = self.clock()
        with self._lock:
            self._queries.append((now, n))
            self._trim(self._queries, now)
            self.totals["queries"] += n
            if latency_s is not None:
                self._lat[self._lat_n % self._lat.shape[0]] = latency_s
                self._lat_n += 1
        self.metrics.inc("serve_queries_total", n, tenant=self.tenant)
        if latency_s is not None:
            self.metrics.observe("serve_query_latency_s", latency_s,
                                 tenant=self.tenant)

    def record_batch(self, rows_real: int, rows_padded: int,
                     latency_s: float) -> None:
        """One micro-batch: ``rows_real`` request rows in a
        ``rows_padded``-row palette chunk."""
        self.record_query(rows_real, latency_s)
        pad = max(int(rows_padded) - int(rows_real), 0)
        with self._lock:
            self.totals["batches"] += 1
            self._rows_real += rows_real
            self._rows_pad += pad
        self.metrics.inc("serve_batches_total", tenant=self.tenant)
        self.metrics.inc("serve_batch_rows_real_total", rows_real,
                         tenant=self.tenant)
        self.metrics.inc("serve_batch_rows_padded_total", pad,
                         tenant=self.tenant)

    def record_insert(self, n: int) -> None:
        now = self.clock()
        with self._lock:
            self._inserts.append((now, n))
            self._trim(self._inserts, now)
            self.totals["inserts"] += n
        self.metrics.inc("serve_inserts_total", n, tenant=self.tenant)

    def record_rejected(self, n: int) -> None:
        with self._lock:
            self.totals["rejected_inserts"] += n
        self.metrics.inc("serve_rejected_inserts_total", n,
                         tenant=self.tenant)

    def record_delete(self, n: int) -> None:
        with self._lock:
            self.totals["deletes"] += n
        self.metrics.inc("serve_deletes_total", n, tenant=self.tenant)

    def record_recall(self, recall: float) -> None:
        with self._lock:
            self._recall = float(recall)
        self.metrics.set("serve_recall_proxy", recall, tenant=self.tenant)

    def record_fanout(self, seg_wins: Sequence[int],
                      dev_wins: Optional[Sequence[int]] = None,
                      seg_candidates: Optional[Sequence[int]] = None,
                      dev_load: Optional[Sequence[int]] = None) -> None:
        """One merged answer's attribution: ``seg_wins[i]`` top-k slots won
        by segment i, ``dev_wins[d]`` by rank d (sharded only),
        ``seg_candidates[i]`` valid candidates segment i offered, and
        ``dev_load[d]`` instances rank d served (routed batches only)."""
        with self._lock:
            self._seg_wins = _accumulate(self._seg_wins, seg_wins)
            if seg_candidates is not None:
                self._seg_cands = _accumulate(self._seg_cands,
                                              seg_candidates)
            if dev_wins is not None:
                self._dev_wins = _accumulate(self._dev_wins, dev_wins)
            if dev_load is not None:
                self._dev_load = _accumulate(self._dev_load, dev_load)
            self._fanout_n += 1
        for name, label, values in (
                ("serve_segment_wins_total", "segment", seg_wins),
                ("serve_device_wins_total", "device", dev_wins),
                ("serve_device_load_total", "device", dev_load)):
            if values is None:
                continue
            v = np.asarray(values, np.int64).ravel()
            at = np.flatnonzero(v)
            if at.size:
                self.metrics.inc_each(name, label,
                                      zip(at.tolist(), v[at].tolist()),
                                      tenant=self.tenant)

    def reset_fanout(self) -> None:
        """Zero the positional fan-out counters (wins, candidates, loads):
        the ``auto`` policy calls it after each re-placement, so the next
        decision reads the traffic since this one.  Rates, latency and
        totals stay."""
        with self._lock:
            self._seg_wins = np.zeros((0,), np.int64)
            self._seg_cands = np.zeros((0,), np.int64)
            self._dev_wins = np.zeros((0,), np.int64)
            self._dev_load = np.zeros((0,), np.int64)
            self._fanout_n = 0

    def shard_balance(self) -> dict:
        """Merge-win and candidate balance across segments and ranks:
        ``merge_win_rate[i]``, segment i's share of the wins;
        ``device_imbalance``, max / mean of the wins per rank (1.0 even,
        0.0 with none); ``device_load_imbalance``, the same over routed
        instances served (replicated serving only)."""
        with self._lock:
            seg_w = self._seg_wins.tolist()
            seg_c = self._seg_cands.tolist()
            dev_w = self._dev_wins.tolist()
            dev_l = self._dev_load.tolist()
            n = self._fanout_n
        tot, dev_tot, load_tot = sum(seg_w), sum(dev_w), sum(dev_l)
        return {
            "n_sampled": n,
            "per_segment_wins": seg_w,
            "per_segment_candidates": seg_c,
            "per_device_wins": dev_w,
            "per_device_load": dev_l,
            "merge_win_rate": [round(w / tot, 4) for w in seg_w] if tot
            else [],
            "device_imbalance": (round(max(dev_w) * len(dev_w) / dev_tot, 3)
                                 if dev_tot else 0.0),
            "device_load_imbalance": (
                round(max(dev_l) * len(dev_l) / load_tot, 3)
                if load_tot else 0.0),
        }

    def _rate(self, dq: deque) -> float:
        now = self.clock()
        with self._lock:
            self._trim(dq, now)
            if not dq:
                return 0.0
            span = max(now - dq[0][0], 1e-9)
            return sum(n for _, n in dq) / span

    def qps(self) -> float:
        return self._rate(self._queries)

    def insert_rate(self) -> float:
        return self._rate(self._inserts)

    def latency_percentiles(self) -> dict:
        with self._lock:
            n = min(self._lat_n, self._lat.shape[0])
            if n == 0:
                return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
            lat = np.sort(self._lat[:n]) * 1e3
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99))}

    def padding_efficiency(self) -> float:
        """Fraction of dispatched batch rows that were real requests."""
        with self._lock:
            real, pad = self._rows_real, self._rows_pad
        return real / (real + pad) if (real + pad) else 1.0

    def snapshot(self) -> dict:
        return {"qps": self.qps(),
                "insert_rate": self.insert_rate(),
                **self.latency_percentiles(),
                "totals": dict(self.totals),
                "padding_efficiency": self.padding_efficiency(),
                "recall_proxy": self._recall,
                "shard_balance": self.shard_balance()}


def recall_proxy(segmented, queries, k: int, n_probes: int = 1) -> float:
    """Recall@k of the segmented index vs exact brute force over its live
    items, on the index's device.  O(n_live * nq): use a small probe set."""
    emb, gid = segmented.live_items()
    if emb.shape[0] == 0:
        return 1.0
    q = torch.as_tensor(queries, dtype=torch.float32, device=emb.device)
    eids, _ = lidx.brute_force_topk(emb, q, min(k, emb.shape[0]),
                                    p=segmented.cfg.p)
    exact = gid[eids]
    got, _ = segmented.query(q, k, n_probes=n_probes)
    hit = (got[:, :, None] == exact[:, None, :]).any(dim=1)
    return float(hit.float().mean())


def store_report(segmented) -> dict:
    """The storage tier's numbers, which the JAX package publishes as the
    store_bytes_per_item and rerank_survivor_frac gauges."""
    return {"precision": segmented.precision,
            "store_bytes_per_item": segmented.store_bytes_per_item(),
            "rerank_survivor_frac": segmented.rerank_survivor_frac}


def occupancy_report(segmented) -> dict:
    """Aggregate segment occupancy for reports."""
    per_seg = segmented.occupancy()
    n_items = sum(s["n_items"] for s in per_seg)
    n_live = sum(s["n_live"] for s in per_seg)
    cap = segmented.cfg.bucket_capacity
    over = [float((seg.state.counts > cap).float().mean())
            for seg in segmented.segments if seg.n_items]
    return {"n_segments": len(per_seg),
            "n_items": n_items,
            "n_live": n_live,
            "tombstone_frac": (n_items - n_live) / n_items if n_items else 0.0,
            "bucket_overflow_frac": float(np.mean(over)) if over else 0.0,
            "segments": per_seg}
