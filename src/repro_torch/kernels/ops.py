"""The ops the index and embedders call, routed by where their input lies.

A CUDA tensor goes to the hand-written kernel (:mod:`.hash_mm`,
:mod:`.dct_mm`, :mod:`.fused_query`, :mod:`.merge`, :mod:`.quantized_query`,
:mod:`.rerank`, :mod:`.simhash_pack`), a CPU tensor to the kernel's plain
version in :mod:`.ref` -- see :mod:`.dispatch`.  Shapes
follow the JAX package's ``repro/kernels/ops.py``: ``B``/``nq`` rows, ``N``
embedding dims, ``L*K`` hashes, ``C`` candidates per query, ``k`` results.
"""

from __future__ import annotations

import torch

from . import dispatch, ref
from .dct_mm import dct_mm
from .fused_query import fused_query_topk as _fused_query_kernel
from .hash_mm import hash_mm
from .merge import merge_topk_kernel, sort_pairs_kernel
from .quantized_query import quantized_query_topk as _quantized_query_kernel
from .rerank import rerank_distances
from .simhash_pack import simhash_pack


def pstable_hash(x, alpha, b, r: float):
    """p-stable hash values ``floor((x @ alpha) / r + b)`` (Eq. 5): x (B,
    N) f32; alpha (N, L*K); b (L*K,).  Returns (B, L*K) int32.  K1 on the
    card, as :func:`pstable_hash_proj`, its projections dropped."""
    return pstable_hash_proj(x, alpha, b, r)[0]


def pstable_hash_proj(x, alpha, b, r: float):
    """Hashes and pre-floor projections: ``proj = (x @ alpha) / r + b``,
    ``hashes = floor(proj)``.  x (B, N) f32; alpha (N, L*K); b (L*K,).
    Returns (hashes (B, L*K) int32, proj (B, L*K) f32)."""
    if dispatch.use_kernel(x):
        return hash_mm(x, alpha, b, r)
    return ref.hash_mm_proj_ref(x, alpha, b, r)


def cheb_embed(fvals, dct_t, scale):
    """Fused DCT + orthonormal scaling: ``(fvals @ dct_t) * scale``.
    fvals (B, N) samples at the Chebyshev nodes; returns (B, N) f32."""
    if dispatch.use_kernel(fvals):
        return dct_mm(fvals, dct_t, scale)
    return ref.dct_mm_ref(fvals, dct_t, scale)


def fused_query_topk(q, db, ids, k: int, p: float = 2.0, valid_items=None):
    """Gather + masked L^p re-rank + top-k without materialising
    (nq, C, N) on the card.  q (nq, N); db (M, N); ids (nq, C) int32, -1 =
    empty slot.  Returns ascending (dists (nq, k) f32, ids (nq, k) int32),
    (+inf, -1) padded.  On the card k must be <= 128 (the kernel's
    contract); a larger k raises rather than falling back."""
    if dispatch.use_kernel(q):
        return _fused_query_kernel(q, db, ids, k, p=p,
                                   valid_items=valid_items)
    return ref.fused_query_topk_ref(q, db, ids, k, p=p,
                                    valid_items=valid_items)


def quantized_query_topk(q, codes, scale, ids, k: int, p: float = 2.0,
                         valid_items=None):
    """:func:`fused_query_topk` over a quantized segment: codes (M, N) int8
    or bf16 with one dequant ``scale`` () f32 -- or over a stack of S
    segments, ``scale`` (S,) f32 and q's rows in S equal blocks, block s
    read against ``scale[s]``.  The queries are mapped into
    code space, candidates scored there with each code widened in
    registers, and the k distances scaled into the fp32 metric (approximate
    within O(scale); the serve layer rescores survivors exactly).  On the
    card k must be <= 128."""
    if dispatch.use_kernel(q):
        return _quantized_query_kernel(q, codes, scale, ids, k, p=p,
                                       valid_items=valid_items)
    return ref.quantized_topk_ref(q, codes, scale, ids, k, p=p,
                                  valid_items=valid_items)


def candidate_distances(q, emb, ids, p: float = 2.0):
    """Masked L^p re-rank distances against pre-gathered rows.

    q (B, N) f32; emb (B, C, N) f32 candidate rows (garbage where the id is
    < 0); ids (B, C) int32, -1 = empty slot.  Returns (B, C) f32, +inf where
    ids is -1.  (The JAX docstring gives ``emb`` as (n_items, N); its code
    and tests pass (B, C, N), which the port follows.)"""
    if dispatch.use_kernel(q):
        return rerank_distances(q, emb, ids, p=p)
    return ref.rerank_ref(q, emb, ids, p)


def simhash_signature(x, alpha):
    """Sign-random-projection signature, bit-packed: x (B, N) f32, alpha
    (N, K) with K a multiple of 32 -> (B, K/32) int32, bit j of word w set
    where ``(x @ alpha)[:, 32w+j] >= 0``."""
    if dispatch.use_kernel(x):
        return simhash_pack(x, alpha)
    return ref.simhash_pack_ref(x, alpha)


def _pad_to_k(dists, ids, k: int):
    """Right-pad the merge pool to at least k columns with (+inf, -1)."""
    m = ids.shape[-1]
    if m < k:
        pad = k - m
        dists = torch.cat([dists, dists.new_full((dists.shape[0], pad),
                                                 torch.inf)], dim=-1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], dim=-1)
    return dists, ids


def merge_topk(dists, ids, k: int):
    """Merge per-segment top-k lists into one top-k.

    dists/ids: (nq, M) f32/int32, the concatenation of every segment's k
    results (-1 id = empty slot).  Returns (dists (nq, k), ids (nq, k)),
    ascending under the total (distance, id) order, (+inf, -1) padded --
    the order that makes a segmented query reproduce a single index's.  On
    the card that is one launch of K3's select route (the masking of
    empty slots inside it) when k <= 128, after the padding when M < k.
    ``-0.0`` and ``+0.0`` are equal in that order (ties by id) on both
    devices, and both write each picked pair's own sign -- but for one
    case no selection reproduces: where a row pairs one id with both
    ``-0.0`` and ``+0.0``, the CPU's network keeps the two equal pairs
    where its compare pattern puts them, and the card writes that id's
    zeros as ``-0.0``."""
    dists, ids = _pad_to_k(dists, ids, k)
    if dispatch.use_kernel(dists):
        return merge_topk_kernel(dists.contiguous(),
                                 ids.to(torch.int32).contiguous(), k)
    d = torch.where(ids < 0, torch.inf, dists).contiguous()
    ids = ids.to(torch.int32).contiguous()
    sd, si = ref.sort_pairs(d, ids)
    sd, si = sd[..., :k], si[..., :k]
    return sd, torch.where(torch.isinf(sd), -1, si)


def merge_topk_unique(dists, ids, k: int):
    """:func:`merge_topk` that also drops repeated ids: the fan-in of the
    replicated sharded query, where a segment held by several ranks may
    answer once per replica with bit-equal (distance, gid) pairs; keeping
    the first makes the merged top k the unreplicated path's.  On rows
    without a repeated id it is bit for bit :func:`merge_topk` (the dedup
    masks nothing and the second sort changes no order).  On the card two
    K3 launches: the full sort of the row (``sort_pairs_kernel``), the
    dedup mask in torch ops (the JAX package computes it outside its
    kernel too), then ``merge_topk_kernel`` for the first k."""
    dists, ids = _pad_to_k(dists, ids, k)
    if dispatch.use_kernel(dists):
        ids = ids.to(torch.int32).contiguous()
        d = torch.where(ids < 0, torch.inf, dists).contiguous()
        sd, si = ref.drop_adjacent_duplicates(*sort_pairs_kernel(d, ids))
        return merge_topk_kernel(sd.contiguous(), si.contiguous(), k)
    return ref.merge_topk_unique_ref(dists, ids, k)
