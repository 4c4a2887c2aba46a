"""Int8 gradient compression with error feedback (a distributed-optimization
trick for the slow cross-pod all-reduce).

The port of ``repro/optim/compress.py``.  The EF-SGD scheme: each rank
quantizes (gradient + carried error) to int8 with a per-tensor scale,
all-reduces the int8 payload (8x fewer bytes on the wire), dequantizes,
and carries the quantization residual into the next step.  Error feedback
preserves convergence (Karimireddy et al. 2019).

The codes and scales are the JAX package's bits as it runs them, jitted
(``compressed_psum`` sits inside a ``shard_map``): XLA folds the scale's
``amax / 127.0`` into a multiply by ``f32(1/127)``, so the port multiplies
(``kernels/quantize.py`` does the same).  Run eagerly, the JAX function
divides, and its scale differs by an ulp now and then.

Where the JAX ``compressed_psum`` runs on each rank of a ``shard_map``
axis, the port's takes the axis' ranks in one process: one gradient tree
and one error tree per rank, and gives back one mean per rank (each on its
rank's device) and each rank's new error.  Trees are ``{name: tensor}``
dicts, nested or not.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

_INV_127 = float(np.float32(1) / np.float32(127))   # an f32 value, exact


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q int8, scale () f32)."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.clamp(amax * _INV_127, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def ef_compress(grads: Any, error: Any) -> Tuple[Any, Any, Any]:
    """(grads + error) -> (q tree, scale tree, new error tree)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    out = _map(one, grads, error)
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def ef_init(params: Any) -> Any:
    """A zero fp32 error tree shaped like ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compressed_psum(grads: Sequence[Any], error: Sequence[Any]
                    ) -> Tuple[List[Any], List[Any]]:
    """All-reduce-mean one mesh axis' gradients in int8 with error feedback.

    ``grads[i]`` and ``error[i]`` are rank i's trees.  Each rank quantizes
    its corrected gradient; every rank then gathers all ranks' int8
    payloads and scales (the scales are tiny, so each rank dequantizes
    every peer's payload exactly) and takes their mean.  Returns (the mean
    tree on each rank's device, each rank's new error tree)."""
    n = len(grads)
    packed = [ef_compress(g, e) for g, e in zip(grads, error)]
    means = []
    for i in range(n):
        def reduce_one(*leaves, i=i):
            qs, ss = leaves[:n], leaves[n:]
            dev = qs[i].device
            all_q = torch.stack([q.to(dev) for q in qs])       # (n, ...) int8
            all_s = torch.stack([s.to(dev) for s in ss])       # (n,)
            deq = all_q.float() * all_s.reshape((-1,) + (1,) * qs[i].dim())
            return deq.sum(dim=0) / n
        means.append(_map(reduce_one, *[p[0] for p in packed],
                          *[p[1] for p in packed]))
    return means, [p[2] for p in packed]
