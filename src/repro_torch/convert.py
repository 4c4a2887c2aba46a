"""Carry state into the port from numpy arrays.

Tests hand the JAX package's family, built tables and sealed segments to
the port with ``np.asarray`` of each leaf, so that both packages compute the
same thing.  The same goes for what torch cannot redraw: a QMC embedder's
``"mc"`` nodes, a ``LazyCoeffs``' blocks and an ALSH's inner family.
The LM stack's parameters cross the same way
(:func:`lm_params_from_numpy`, :func:`lm_params_to_numpy`), as does the
serve step's hashing state (:func:`lsh_serve_params_from_numpy`).
Nothing here imports jax: the arrays arrive as numpy.  A bf16 array
arrives as numpy's ``bfloat16`` (the ml_dtypes type), which torch cannot
take; it crosses as its uint16 bits and is viewed as bf16 again.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.hashes import (ALSH, LazyCoeffs, LazyPStableHash, PStableHash,
                          SimHash)
from .core.index import Family, LSHIndexState
from .kernels import dispatch
from .serve.segments import Segment


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev).to(dtype).contiguous()


def rows_from_numpy(db, device=None) -> torch.Tensor:
    """Stored rows in their own dtype: int8 codes, bf16 codes (via their
    uint16 bits) or fp32 embeddings."""
    dev = dispatch.resolve_device(device)
    a = np.asarray(db)
    if a.dtype == np.int8:
        return _tensor(a, torch.int8, dev)
    if a.dtype.name == "bfloat16":
        bits = torch.as_tensor(a.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev).contiguous()
    return _tensor(a, torch.float32, dev)


def family_from_numpy(alpha, b, mix, device=None) -> Family:
    """(alpha (N, L*K) f32, b (L*K,) f32, mix (L, K) uint32) -> the port's
    family on ``device``; ``mix`` is held as int64 in [0, 2^32)."""
    dev = dispatch.resolve_device(device)
    mix64 = np.asarray(mix).astype(np.uint32).astype(np.int64)
    return (_tensor(alpha, torch.float32, dev), _tensor(b, torch.float32, dev),
            _tensor(mix64, torch.int64, dev))


def simhash_from_numpy(alpha, device=None) -> SimHash:
    """A JAX ``SimHash``'s ``alpha`` (N, K) -> the port's ``SimHash`` on
    ``device``, f32."""
    return SimHash(alpha=_tensor(alpha, torch.float32,
                                 dispatch.resolve_device(device)))


def state_from_numpy(alpha, b, mix, table, counts, db, device=None
                     ) -> LSHIndexState:
    """A built index's leaves -> the port's ``LSHIndexState``.  ``db`` keeps
    its dtype: fp32 rows, or a quantized segment's int8 or bf16 codes."""
    dev = dispatch.resolve_device(device)
    a, bb, m = family_from_numpy(alpha, b, mix, device=dev)
    return LSHIndexState(alpha=a, b=bb, mix=m,
                         table=_tensor(table, torch.int32, dev),
                         counts=_tensor(counts, torch.int32, dev),
                         db=rows_from_numpy(db, device=dev))


def quantized_segment_from_numpy(codes, scale, pool, *, family, table, counts,
                                 gids, live, n_items: int, device=None
                                 ) -> Segment:
    """A sealed int8/bf16 segment of the JAX package -> the port's
    ``Segment``: ``codes`` (capacity, N) int8 or bf16, ``scale`` () f32,
    ``pool`` (capacity, N) f32 survivor rows, ``family`` (alpha, b, mix),
    the bucket ``table``/``counts``, ``gids`` (capacity,) int32 and ``live``
    (capacity,) bool."""
    dev = dispatch.resolve_device(device)
    live_t = _tensor(live, torch.bool, dev)
    return Segment(
        state=state_from_numpy(*family, table, counts, codes, device=dev),
        gids=_tensor(gids, torch.int32, dev), live=live_t,
        n_items=int(n_items), n_live=int(live_t[:int(n_items)].sum()),
        sealed=True, scale=_tensor(scale, torch.float32, dev).reshape(()),
        pool=np.array(pool, dtype=np.float32))


def basis_constants_from_numpy(pre, mat, scale, device=None):
    """The Chebyshev embedder's (pre (N,), mat (N, N), scale (N,)) as f32
    tensors, ready for ``BasisEmbedder.set_constants``."""
    dev = dispatch.resolve_device(device)
    return tuple(_tensor(t, torch.float32, dev) for t in (pre, mat, scale))


def qmc_nodes_from_numpy(embedder, nodes):
    """Install ``nodes`` (N,), e.g. a JAX ``QMCEmbedder``'s ``"mc"`` node
    set, as the port's ``QMCEmbedder``'s f32 node set; returns the
    embedder."""
    nodes = np.asarray(nodes, dtype=np.float32).reshape(-1)
    if nodes.shape != (embedder.n_dims,):
        raise ValueError(f"want {embedder.n_dims} nodes, got {nodes.shape}")
    embedder._nodes = nodes
    return embedder


def lazy_coeffs_from_numpy(blocks, seed: int, p: float = 2.0, device=None
                           ) -> LazyCoeffs:
    """A JAX ``LazyCoeffs``' blocks (each (128, K)) -> the port's
    ``LazyCoeffs`` holding them as its first blocks; blocks past them are
    the port's own draws from ``seed``."""
    blocks = [np.array(blk, dtype=np.float32) for blk in blocks]
    coeffs = LazyCoeffs(seed, blocks[0].shape[1], p,
                        device=dispatch.resolve_device(device))
    coeffs._blocks = blocks
    return coeffs


def lazy_hash_from_numpy(blocks, b, r: float, seed: int = 0, p: float = 2.0,
                         device=None) -> LazyPStableHash:
    """A JAX ``LazyPStableHash`` (its coefficient blocks, b and r) -> the
    port's."""
    dev = dispatch.resolve_device(device)
    return LazyPStableHash(
        coeffs=lazy_coeffs_from_numpy(blocks, seed, p, device=dev),
        b=_tensor(b, torch.float32, dev), r=float(r))


def alsh_from_numpy(m: int, scale_u: float, variant: str, alpha, b=None,
                    r: float = 1.0, device=None) -> ALSH:
    """A JAX ``ALSH`` -> the port's: its inner family's alpha (N + m, K),
    and for ``"l2"`` its b (K,) and r."""
    dev = dispatch.resolve_device(device)
    if variant == "l2":
        inner = PStableHash(alpha=_tensor(alpha, torch.float32, dev),
                            b=_tensor(b, torch.float32, dev), r=float(r))
    elif variant == "sign":
        inner = simhash_from_numpy(alpha, device=dev)
    else:
        raise ValueError(variant)
    return ALSH(m=int(m), scale_u=float(scale_u), inner=inner,
                variant=variant)


# -- the LM stack -------------------------------------------------------------


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy: a bf16 tensor as its uint16 bits."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def _lm_path(name: str):
    """A parameter's module name -> (path in the JAX tree, index on the
    stack's leading axis or None): ``layers.3.attn.wq`` -> (("layers",
    "attn", "wq"), 3), ``groups.1.rg2.rg.lam`` -> (("groups", "rg2", "rg",
    "lam"), 1), ``embed.tok`` -> (("embed", "tok"), None).  The stacks are
    the families' ``layers``, the hybrid's ``groups`` and ``tail``, and the
    enc-dec's ``enc`` and ``dec``."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def lm_params_from_numpy(model, tree) -> None:
    """Load the JAX ``api.init`` tree ``tree`` (numpy leaves; each stack's
    leaves on a leading axis) into ``model`` (a family module of
    ``models.model``), one block per slice, each leaf in the
    parameter's own dtype and device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, layer = _lm_path(name)
            leaf = tree
            for key in path:
                leaf = leaf[key]
            a = np.asarray(leaf) if layer is None else np.asarray(leaf)[layer]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: {a.shape} vs {tuple(p.shape)}")
            p.copy_(rows_from_numpy(a, device=p.device))


def lm_params_to_numpy(model, leaves=None) -> dict:
    """The inverse: ``model``'s parameters as the JAX tree (names, nesting,
    layers stacked on a leading axis), numpy on the host.  ``leaves``, a
    ``{name: tensor}`` dict keyed like ``model.named_parameters()`` (the
    gradients, say, or AdamW's moments), is laid out in their place."""
    tree: dict = {}
    stacks: dict = {}
    for name, p in model.named_parameters():
        t = p if leaves is None else leaves[name]
        path, layer = _lm_path(name)
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _to_numpy(t)
        else:
            stacks.setdefault(path, {})[layer] = _to_numpy(t)
    for path, by_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_layer[i] for i in sorted(by_layer)])
    return tree


def lsh_serve_params_from_numpy(nodes, volume, support, alpha, b, r,
                                device=None):
    """A JAX ``LshServeParams`` (nodes (N,), volume, support (V,), alpha
    (N, K), b (K,), r) -> the port's, f32 on ``device``."""
    from .runtime.steps import LshServeParams
    dev = dispatch.resolve_device(device)
    return LshServeParams(
        nodes=_tensor(nodes, torch.float32, dev), volume=float(volume),
        support=_tensor(support, torch.float32, dev),
        alpha=_tensor(alpha, torch.float32, dev),
        b=_tensor(b, torch.float32, dev), r=float(r))
