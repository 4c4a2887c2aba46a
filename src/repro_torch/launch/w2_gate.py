"""The Wasserstein tenant's quality gate against the closed-form W2 oracle.

    python -m repro_torch.launch.w2_gate --device cpu --smoke
    python -m repro_torch.launch.w2_gate               # on the card

The port of the recall half of ``benchmarks/bench_wasserstein_serve.py``:
a ``wasserstein`` tenant indexes 1-D Gaussians (mu ~ U[-1, 1], sigma ~
U[0.1, 1]) by their clipped quantile embeddings (``embed_gaussian``) and
answers W^2 nearest-neighbour queries; recall@10 is measured against brute
force over the Olkin-Pukelsheim closed form (``gaussian_w2``), so it
scores the whole pipeline (clip loss, QMC quantile levels, bucketing,
multi-probe) against the exact metric.  The bench's config: N = 64, 16
tables x 4 hashes, 1024 buckets of 64 slots, 8 probes, r swept over (0.25,
0.5, 1.0); 4,096 Gaussians and 64 queries, or 512 and 16 with ``--smoke``.
The best r must reach recall@10 >= 0.9, the bench's bar.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core import wasserstein
from ..serve import ServableRegistry, ServableSpec

N_DIMS = 64
K = 10
N_PROBES = 8
R_SWEEP = (0.25, 0.5, 1.0)
MIN_RECALL = 0.9


def gaussian_set(rng: np.random.Generator, n: int):
    """(mu, sigma), each (n,) f32: mu ~ U[-1, 1], sigma ~ U[0.1, 1]."""
    mu = rng.uniform(-1.0, 1.0, size=n)
    sig = rng.uniform(0.1, 1.0, size=n)
    return mu.astype(np.float32), sig.astype(np.float32)


def gate_spec(r: float, n_db: int) -> ServableSpec:
    return ServableSpec(name=f"w2-r{r}", n_dims=N_DIMS, p=2.0, r=r,
                        embedder="wasserstein", n_tables=16, n_hashes=4,
                        log2_buckets=10, bucket_capacity=64,
                        segment_capacity=max(1024, n_db // 4),
                        insert_chunk=256, chunk_sizes=(16, 64))


def oracle_topk(qmu, qsig, mu, sig, k: int = K) -> np.ndarray:
    """The k nearest of (mu, sig) to each query by the closed-form W2:
    (n_q, k) indices."""
    w2 = wasserstein.gaussian_w2(qmu[:, None], qsig[:, None], mu[None, :],
                                 sig[None, :]).numpy()
    return np.argsort(w2, axis=1, kind="stable")[:, :k]


def run(n_db: int = 4096, n_q: int = 64, device=None) -> dict:
    """Recall@10 against the W2 oracle for each r of the sweep, on
    ``device`` (default: the card); the best r and its recall.  The data
    is drawn from seed 0, as the bench draws it."""
    rng = np.random.default_rng(0)
    mu, sig = gaussian_set(rng, n_db)
    qmu, qsig = gaussian_set(rng, n_q)
    exact = oracle_topk(qmu, qsig, mu, sig)
    recalls = {}
    for r in R_SWEEP:
        sv = ServableRegistry(device=device).register(gate_spec(r, n_db))
        gids = sv.insert(sv.embedder.embed_gaussian(mu, sig))
        if gids[0] != 0 or gids[-1] != n_db - 1:
            raise AssertionError("gids are not 0..n_db-1")
        q_emb = sv.embedder.embed_gaussian(qmu, qsig)
        got, _ = sv.index.query(q_emb, K, n_probes=N_PROBES)
        got = got.cpu().numpy()
        recalls[r] = float((got[:, :, None] == exact[:, None, :])
                           .any(axis=1).mean())
    best_r = max(R_SWEEP, key=lambda r: (recalls[r], r))
    return {"n_db": n_db, "n_q": n_q,
            "recall_at_10": {str(r): v for r, v in recalls.items()},
            "best_r": best_r, "best_recall_at_10": recalls[best_r]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="512 Gaussians and 16 queries")
    args = ap.parse_args(argv)
    n_db, n_q = (512, 16) if args.smoke else (4096, 64)
    res = run(n_db, n_q, device=args.device)
    print("[w2_gate]", json.dumps(res))
    if res["best_recall_at_10"] < MIN_RECALL:
        raise SystemExit(f"[w2_gate] best recall@{K} "
                         f"{res['best_recall_at_10']} < {MIN_RECALL}")
    print("[w2_gate] OK")
    return res


if __name__ == "__main__":
    main()
