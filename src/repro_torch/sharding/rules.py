"""Logical-axis sharding rules (MaxText-style) mapping every parameter,
batch and cache tensor of the LM stack onto a (data, model) mesh of ranks,
and the blocks each rank holds.

The port of ``repro/sharding/rules.py``, the same policies:

* TP  -- heads / d_ff / experts / lru width sharded over ``model``.
* DP  -- batch over ``("pod", "data")`` when divisible (falls back for a
         global batch of 1).
* FSDP/ZeRO-3 -- for ``cfg.fsdp_params`` archs, the d_model (or
         equivalent) axis of each weight is also sharded over the data
         axes.
* SP  -- KV-cache *length* sharded over ``model`` for decode shapes.
* Vocab -- the token embedding sharded over ``model`` on the vocab axis.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (the JAX ``PartitionSpec``'s entries; a one-name tuple
is written as the name, as ``PartitionSpec`` normalises it).  The rules
dispatch on the JAX package's leaf names: a parameter's module name
(``layers.3.attn.wq``) maps to its JAX path (``layers/attn/wq``) through
``convert._lm_path``.  The port's blocks are not stacked, so the leading
``None`` of a JAX stacked leaf's spec has no counterpart here.  The rules
read only ``mesh.shape`` (axis -> size) and ``mesh.axis_names``, so they
take the JAX package's test mesh shapes (a ``pod`` axis included) as well
as the port's ``launch.mesh.PodMesh``.

:class:`Sharded` is a tensor laid out over a ``PodMesh``: rank ``(di,
mi)`` holds its block, a tensor of its own on its device (a replicated
dim gives each rank its own copy, as a real mesh holds one per chip).
:func:`shard` places the blocks, :func:`gather` reassembles the tensor bit
for bit, :func:`scatter` copies a whole tensor's slices back into the
blocks.  A sharded dim must divide evenly (every spec of these rules does
at the configs' sizes; :func:`shard` raises otherwise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

TP = "model"

Spec = Tuple[Any, ...]


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes: ('pod', 'data') on multi-pod, ('data',)
    else."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _divisible(n: int, mesh, axes) -> bool:
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return n % size == 0 and n >= size


def batch_axis(mesh, global_batch: int):
    """Largest prefix of dp axes that divides the batch (None if batch=1)."""
    axes = dp_axes(mesh)
    while axes and not _divisible(global_batch, mesh, axes):
        axes = axes[:-1]
    return axes if axes else None


def _entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: None, a name, or a
    tuple of two or more names."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def _named_shapes(params) -> Dict[str, tuple]:
    """``{module name: shape}`` of a model (``named_parameters``) or of a
    ``{name: tensor or shape}`` dict."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(getattr(t, "shape", t)) for n, t in params.items()}


def _param_spec(names: Tuple[str, ...], core: tuple, mesh, fsdp) -> Spec:
    """The spec of one parameter block of shape ``core`` whose JAX path is
    ``names`` (``repro/sharding/rules.py:52``, without the stacked leaves'
    leading entry)."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    # ---- embeddings ----
    if name == "tok":
        return (_spec(TP, None) if _divisible(core[0], mesh, TP)
                else _spec(None, TP))
    if name == "out" and parent == "embed":
        return _spec(None, TP)
    # ---- norms / scalars / biases ----
    if len(core) <= 1:
        return (None,) * len(core)
    # ---- attention ----
    if name == "wq":
        return _spec(fsdp, TP, None)
    if name in ("wk", "wv"):
        head_ax = TP if _divisible(core[1], mesh, TP) else None
        return _spec(fsdp, head_ax, None)
    if name == "wo":
        return _spec(TP, None, fsdp)
    # ---- FFN ----
    if name in ("gate", "up"):
        return _spec(fsdp, TP)
    if name == "down":
        return _spec(TP, fsdp)
    # ---- MoE ----
    if name == "router":
        return _spec(None, None)
    if name in ("w_gate", "w_up"):
        return _spec(TP, fsdp, None)
    if name == "w_down":
        return _spec(TP, None, fsdp)
    # ---- mamba ----
    if name == "in_proj":
        return _spec(fsdp, TP)
    if name == "conv_w":
        return _spec(None, TP)
    if name == "out_proj":
        return _spec(TP, fsdp)
    # ---- rglru ----
    if name in ("in_x", "in_gate"):
        return _spec(fsdp, TP)
    if name in ("w_a", "w_i"):
        return _spec(TP, None)
    if name == "out" and len(core) == 2:
        return _spec(TP, fsdp)
    # ---- fallback: shard the biggest core dim over model if divisible ----
    big = max(range(len(core)), key=lambda i: core[i])
    if _divisible(core[big], mesh, TP):
        spec = [None] * len(core)
        spec[big] = TP
        return tuple(spec)
    return (None,) * len(core)


def param_specs(cfg, params, mesh) -> Dict[str, Spec]:
    """``{module name: spec}`` for a model (its ``named_parameters``, on
    any device, ``meta`` included) or a ``{name: tensor or shape}``
    dict."""
    from ..convert import _lm_path
    fsdp = dp_axes(mesh) if cfg.fsdp_params else None
    return {name: _param_spec(_lm_path(name)[0], shape, mesh, fsdp)
            for name, shape in _named_shapes(params).items()}


def batch_specs(cfg, batch: Dict[str, Any], mesh, global_batch: int
                ) -> Dict[str, Spec]:
    """Each batch leaf's rows over the data axes that divide the batch."""
    bx = batch_axis(mesh, global_batch)
    out = {}
    for k, leaf in batch.items():
        nd = len(getattr(leaf, "shape", ()))
        out[k] = () if nd == 0 else _spec(bx, *((None,) * (nd - 1)))
    return out


def _cache_leaf(name: str, shape: tuple, mesh, bx, hybrid: bool) -> Spec:
    """``repro/sharding/rules.py:144``'s two leaf rules (the hybrid's
    group-stacked caches, the other families')."""
    def sp(n):
        return TP if _divisible(n, mesh, TP) else None
    if hybrid:
        if name in ("k", "v") and len(shape) == 5:
            return _spec(None, bx, sp(shape[2]), None, None)
        if name == "conv" and len(shape) == 4:
            return _spec(None, bx, None, sp(shape[-1]))
        if name == "h" and len(shape) == 3:
            return _spec(None, bx, sp(shape[-1]))
        if name == "ssm" and len(shape) == 5:
            return _spec(None, bx, sp(shape[2]), None, None)
        return (None,) * len(shape)
    if name in ("k", "v", "ck", "cv"):
        if len(shape) == 5:      # (L, B, T, KV, D)
            return _spec(None, bx, sp(shape[2]), None, None)
        if len(shape) == 4:      # (B, T, KV, D)
            return _spec(bx, sp(shape[1]), None, None)
    if name == "ssm":            # (L, B, H, P, N)
        return _spec(None, bx, sp(shape[2]), None, None)
    if name == "conv":           # (L, B, K-1, C)
        return _spec(None, bx, None, sp(shape[-1]))
    if name == "h":              # (L, B, lru)
        return _spec(None, bx, sp(shape[-1]))
    return (None,) * len(shape)


def cache_specs(cfg, cache: Dict[str, Any], mesh, global_batch: int
                ) -> Dict[str, Any]:
    """Decode-cache specs, a tree like ``cache``: KV caches get batch over
    the data axes and SP (length over ``model`` where it divides);
    recurrent states shard their width."""
    bx = batch_axis(mesh, global_batch)
    hybrid = cfg.family == "hybrid"

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                _cache_leaf(k, tuple(v.shape), mesh, bx, hybrid)
                for k, v in tree.items()}
    return walk(cache)


# ---------------------------------------------------------------------------
# blocks on a mesh of ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh (the JAX ``NamedSharding``): where
    ``checkpoint.restore`` places a leaf."""

    mesh: Any
    spec: Spec


def named(mesh, spec_tree: Any) -> Any:
    """``spec_tree`` with each spec paired with ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return NamedSpec(mesh, tuple(spec_tree))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coords(mesh, di: int, mi: int) -> Dict[str, int]:
    return {mesh.axis_names[0]: di, mesh.axis_names[1]: mi}


def ranks(mesh) -> Iterator[Tuple[int, int]]:
    """Every rank ``(di, mi)`` of a pod mesh, row by row."""
    d, m = (mesh.shape[a] for a in mesh.axis_names)
    for di in range(d):
        for mi in range(m):
            yield di, mi


def parts(spec: Spec, mesh) -> Tuple[int, ...]:
    """How many blocks each dim splits into."""
    return tuple(math.prod(mesh.shape[a] for a in _axes(e)) for e in spec)


def block_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """Every rank's block shape (the dims divide evenly)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for shape {tuple(shape)}")
    out = []
    for n, k in zip(shape, parts(spec, mesh)):
        if n % k:
            raise ValueError(f"dim {n} does not split into {k} blocks "
                             f"(spec {spec}, shape {tuple(shape)})")
        out.append(n // k)
    return tuple(out)


def block_slices(shape: tuple, spec: Spec, mesh, di: int, mi: int
                 ) -> Tuple[slice, ...]:
    """Rank ``(di, mi)``'s block as slices of the whole tensor: a dim over
    axes (a, b) is split into size(a) x size(b) blocks, a major."""
    bshape = block_shape(shape, spec, mesh)
    at = _coords(mesh, di, mi)
    out = []
    for e, w in zip(spec, bshape):
        idx = 0
        for a in _axes(e):
            idx = idx * mesh.shape[a] + at[a]
        out.append(slice(idx * w, (idx + 1) * w))
    return tuple(out)


def is_owner(spec: Spec, mesh, di: int, mi: int) -> bool:
    """Is rank ``(di, mi)`` the first of its block's replicas (0 along
    every axis the spec does not use)?"""
    used = {a for e in spec for a in _axes(e)}
    return all(c == 0 for a, c in _coords(mesh, di, mi).items()
               if a not in used)


@dataclasses.dataclass(eq=False)
class Sharded:
    """A ``shape`` tensor laid out over ``mesh`` by ``spec``:
    ``blocks[di][mi]`` is rank ``(di, mi)``'s block, on its device."""

    shape: tuple
    dtype: torch.dtype
    spec: Spec
    mesh: Any
    blocks: List[List[torch.Tensor]]
    _slices: Dict[Tuple[int, int], Tuple[slice, ...]] = dataclasses.field(
        default_factory=dict, repr=False)

    def block(self, di: int, mi: int) -> torch.Tensor:
        return self.blocks[di][mi]

    def slices(self, di: int, mi: int) -> Tuple[slice, ...]:
        sl = self._slices.get((di, mi))
        if sl is None:     # a step asks for them at every gather and scatter
            sl = self._slices[(di, mi)] = block_slices(
                self.shape, self.spec, self.mesh, di, mi)
        return sl

    def ranks(self) -> Iterator[Tuple[int, int]]:
        return ranks(self.mesh)

    def nbytes(self, di: int, mi: int) -> int:
        b = self.blocks[di][mi]
        return b.numel() * b.element_size()

    def named(self) -> NamedSpec:
        return NamedSpec(self.mesh, self.spec)


def shard(t: torch.Tensor, spec: Spec, mesh) -> Sharded:
    """Place ``t``'s blocks on ``mesh``'s ranks: each rank gets a copy of
    its slice on its device (a tensor of its own)."""
    spec = tuple(spec)
    blocks = [[None] * mesh.shape[mesh.axis_names[1]]
              for _ in range(mesh.shape[mesh.axis_names[0]])]
    for di, mi in ranks(mesh):
        sl = block_slices(tuple(t.shape), spec, mesh, di, mi)
        blocks[di][mi] = t[sl].to(mesh.devices[di][mi],
                                  copy=True).contiguous()
    return Sharded(tuple(t.shape), t.dtype, spec, mesh, blocks)


def zeros(shape: tuple, dtype: torch.dtype, spec: Spec, mesh) -> Sharded:
    """A sharded tensor of zeros, each rank's block made on its device."""
    spec = tuple(spec)
    bshape = block_shape(tuple(shape), spec, mesh)
    blocks = [[torch.zeros(bshape, dtype=dtype, device=mesh.devices[di][mi])
               for mi in range(mesh.shape[mesh.axis_names[1]])]
              for di in range(mesh.shape[mesh.axis_names[0]])]
    return Sharded(tuple(shape), dtype, spec, mesh, blocks)


def gather(s: Sharded, device=None, out: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """The whole tensor, bit for bit: each block copied from its first
    replica into ``out`` (or a new tensor on ``device``, default rank
    (0, 0)'s)."""
    if out is None:
        dev = s.mesh.devices[0][0] if device is None else device
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    with torch.no_grad():
        for di, mi in owners(s):
            out[s.slices(di, mi)].copy_(s.blocks[di][mi])
    return out


def owners(s: Sharded) -> List[Tuple[int, int]]:
    """The first replica of each of ``s``'s blocks (:func:`is_owner`)."""
    return [r for r in s.ranks() if is_owner(s.spec, s.mesh, *r)]


def scatter(full: torch.Tensor, s: Sharded) -> None:
    """Copy each rank's slice of ``full`` into its block of ``s``."""
    with torch.no_grad():
        for di, mi in s.ranks():
            s.blocks[di][mi].copy_(full[s.slices(di, mi)])


def shard_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """:func:`shard` of every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    return shard(tree, spec_tree, mesh)


def gather_tree(tree: Any, device=None) -> Any:
    """:func:`gather` of every :class:`Sharded` leaf of a nested dict;
    other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return gather(tree, device) if isinstance(tree, Sharded) else tree


def rank_bytes(tree: Any, di: int, mi: int) -> int:
    """Bytes of rank ``(di, mi)``'s blocks over the :class:`Sharded`
    leaves of a nested dict."""
    if isinstance(tree, dict):
        return sum(rank_bytes(v, di, mi) for v in tree.values())
    return tree.nbytes(di, mi) if isinstance(tree, Sharded) else 0


def spec_bytes(shapes: Dict[str, tuple], specs: Dict[str, Spec], mesh,
               itemsize) -> int:
    """The bytes one rank's blocks of ``shapes`` take under ``specs`` (every
    rank's alike: the dims divide evenly).  ``itemsize`` is an int or a
    ``{name: int}`` dict."""
    total = 0
    for name, shape in shapes.items():
        size = itemsize if isinstance(itemsize, int) else itemsize[name]
        total += math.prod(block_shape(shape, specs[name], mesh)) * size
    return total
