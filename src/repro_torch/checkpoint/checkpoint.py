"""Atomic, checksummed checkpoints (npz + json manifest).

The port of ``repro/checkpoint/checkpoint.py``, its on-disk layout
unchanged, so either package restores the other's checkpoints:

* ``<dir>/step_{step:010d}/arrays.npz`` holds the leaves as ``a{i}``, in
  the sorted order of their keys; a key is the leaf's path through nested
  dicts (the dict key) and lists or tuples (the index), joined by ``/``;
* ``manifest.json`` holds ``{"step", "keys": {key: {"file", "shape",
  "dtype", "crc32"}}, "extra", "manifest_crc32"}``: a crc32 over each
  array's stored bytes and one over the manifest itself;
* **atomic**: written to ``<dir>/tmp-<step>``, fsync'd, then renamed to
  ``step_<k>`` (``os.replace``) and the directory fsync'd -- a crash
  leaves the whole new checkpoint or none of it;
* **checksummed**: ``restore`` / ``verify`` raise
  :class:`CheckpointCorruptError` naming the damaged file;
* **keep-last-k** garbage collection that never deletes the last
  verifiable checkpoint;
* ``latest_step`` skips a partial save (a stale ``tmp-*`` dir, a step
  without a readable manifest);
* ``save_async`` copies the tree to the host now and writes it on a
  background thread (``wait`` joins it).

Leaves are torch tensors, numpy arrays or ``sharding.rules.Sharded``
tensors over a mesh of ranks, which are saved whole (their blocks
gathered), so a checkpoint does not depend on the mesh it was saved from
and either package reads it.  bf16 has no numpy dtype: a
``torch.bfloat16`` tensor is stored as its raw ``uint16`` bits under the
dtype string ``"bfloat16"``, as the JAX package stores its ml_dtypes
arrays, and read back the same way.  :func:`restore` takes a tree of
:class:`ArraySpec` ``(shape, dtype)`` leaves (the JAX package takes
``ShapeDtypeStruct``s), checks both against the manifest and returns torch
tensors on ``device``; with ``shardings`` (a tree of
``sharding.rules.NamedSpec``, the JAX ``NamedSharding``s) a leaf comes back
sharded over that spec's mesh instead, so a checkpoint saved from a (2, 4)
mesh restores onto a (4, 2) one (the elastic re-mesh), and a ``Sharded``
target leaf comes back laid out as it is.

Fault site (``serve/faults.py``): ``ckpt.rename`` fires after the temp dir
is fully written, before the rename.

Telemetry, as the JAX package's, labelled by the checkpoint directory's
basename (the registry's tenant name): a write runs under a ``ckpt.save``
span and counts ``ckpt_saves_total`` and ``ckpt_save_latency_s``; a
restore runs under ``ckpt.restore`` and counts ``ckpt_restores_total``
and ``ckpt_restore_latency_s``; every failed check (``verify``,
``restore``, the garbage collector's) counts ``ckpt_corrupt_total``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import dispatch
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..sharding import rules

_SEP = "/"


def _tenant(ckpt_dir: str) -> str:
    """The metric and span label of a checkpoint directory: its basename
    (the registry checkpoints each tenant under ``<root>/<name>``)."""
    return os.path.basename(os.path.normpath(ckpt_dir)) or "default"


class ArraySpec(NamedTuple):
    """A leaf of a :func:`restore` target: the shape and torch dtype the
    checkpoint must hold at its key."""

    shape: tuple
    dtype: torch.dtype


class CheckpointCorruptError(Exception):
    """A checkpoint failed its integrity checks; ``path`` names the
    damaged file (manifest or array container)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype string for a torch dtype ("float32", "bool",
    "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def _flatten(tree: Any, prefix: str = "") -> dict:
    """``{key: leaf}`` of a tree of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, ArraySpec):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def _unflatten(tree: Any, flat: dict, prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``flat[its key]``."""
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, key(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ArraySpec):
        return type(tree)(_unflatten(v, flat, key(i))
                          for i, v in enumerate(tree))
    return flat[prefix]


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf as numpy: bf16 tensors as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def to_host(tree: Any) -> dict:
    """A host copy of ``tree`` to hand to :func:`save_host`: ``{key:
    (stored array, dtype string)}`` for every leaf.  A caller whose
    tensors change in place copies them under its lock, then writes with
    no lock held."""
    out = {}
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, rules.Sharded):
            leaf = rules.gather(leaf, device="cpu")
        arr = _host(leaf)
        if isinstance(leaf, torch.Tensor):
            dtype_str = _dtype_name(leaf.dtype)
        else:
            dtype_str = str(arr.dtype)
            if arr.dtype.kind not in "biufc":  # raw-stored foreign dtypes
                arr = arr.view(np.uint8 if arr.dtype.itemsize == 1
                               else np.uint16)
        out[key] = (arr, dtype_str)
    return out


def _manifest_crc(manifest: dict) -> int:
    """crc32 over the canonical manifest JSON, excluding the crc field."""
    body = {k: v for k, v in manifest.items() if k != "manifest_crc32"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode())


def _fire(site: str) -> None:
    # late import: the serve layer imports this module
    from ..serve import faults
    faults.fire(site)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (best effort
    where the filesystem refuses directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Blocking save; returns the final checkpoint path.  ``extra`` is a
    JSON-able dict stored in the manifest (``load_extra`` reads it)."""
    return save_host(ckpt_dir, step, to_host(tree), keep, extra)


def save_host(ckpt_dir: str, step: int, flat: dict, keep: int = 3,
              extra: Optional[dict] = None) -> str:
    """:func:`save` of a tree already copied to the host by
    :func:`to_host`."""
    tenant = _tenant(ckpt_dir)
    tr = obs_trace.tracer()
    t0 = tr.clock()
    with tr.span("ckpt.save", tenant=tenant, step=int(step)):
        final = _save_body(ckpt_dir, step, flat, keep, extra)
    reg = obs_metrics.registry()
    reg.inc("ckpt_saves_total", tenant=tenant)
    reg.observe("ckpt_save_latency_s", tr.clock() - t0, tenant=tenant)
    return final


def _save_body(ckpt_dir: str, step: int, flat: dict, keep: int,
               extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "keys": {}}
    if extra is not None:
        manifest["extra"] = extra
    arrays = {}
    for i, (key, (arr, dtype_str)) in enumerate(sorted(flat.items())):
        name = f"a{i}"
        arrays[name] = arr
        manifest["keys"][key] = {
            "file": name, "shape": list(arr.shape), "dtype": dtype_str,
            # crc over the *stored* bytes: restore re-hashes what it read
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    manifest["manifest_crc32"] = _manifest_crc(manifest)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    with open(npz_path, "rb+") as f:
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fire("ckpt.rename")
    if os.path.exists(final):
        # re-saving a step: move the old one aside first, so there is
        # never an instant with no checkpoint at this step on disk
        aside = os.path.join(ckpt_dir, f"old-{step}")
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
        os.replace(tmp, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep)
    return final


_save_thread: Optional[threading.Thread] = None


def save_async(ckpt_dir: str, step: int, tree: Any, keep: int = 3,
               extra: Optional[dict] = None) -> threading.Thread:
    """Copy ``tree`` to host memory now; write it on a background thread
    (after the previous one has finished).  Returns the thread."""
    global _save_thread
    host = to_host(tree)
    wait()
    _save_thread = threading.Thread(
        target=save_host, args=(ckpt_dir, step, host, keep, extra),
        daemon=True, name="ckpt-save")
    _save_thread.start()
    return _save_thread


def wait(timeout: Optional[float] = None) -> None:
    """Join the background save, if one is running (at most ``timeout``
    seconds when given)."""
    if _save_thread is not None and _save_thread.is_alive():
        _save_thread.join(timeout)


def _read_manifest(path: str) -> dict:
    """Parse and check one checkpoint's manifest.  A manifest from before
    the checksums (no ``manifest_crc32``) loads: nothing to check."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(mpath, f"unreadable manifest ({e})")
    if "keys" not in manifest:
        raise CheckpointCorruptError(mpath, "manifest has no 'keys' table")
    want = manifest.get("manifest_crc32")
    if want is not None and _manifest_crc(manifest) != want:
        raise CheckpointCorruptError(mpath, "manifest crc mismatch")
    return manifest


def verify(ckpt_dir: str, step: int, deep: bool = True) -> dict:
    """Check ``step``; return its manifest or raise
    :class:`CheckpointCorruptError`.  ``deep`` also loads every array and
    checks its crc32; ``deep=False`` is the manifest-only check ``_gc``
    uses."""
    try:
        return _verify_body(ckpt_dir, step, deep)
    except CheckpointCorruptError:
        obs_metrics.registry().inc("ckpt_corrupt_total",
                                   tenant=_tenant(ckpt_dir))
        raise


def _verify_body(ckpt_dir: str, step: int, deep: bool) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    manifest = _read_manifest(path)
    npz_path = os.path.join(path, "arrays.npz")
    if not os.path.exists(npz_path):
        raise CheckpointCorruptError(npz_path, "array container missing")
    if not deep:
        return manifest
    try:
        with np.load(npz_path) as data:
            for key, meta in manifest["keys"].items():
                _checked_array(data, meta, npz_path, key)
    except CheckpointCorruptError:
        raise
    except Exception as e:         # BadZipFile, truncated npy headers, ...
        raise CheckpointCorruptError(npz_path,
                                     f"unreadable array container ({e})")
    return manifest


def _checked_array(data, meta: dict, npz_path: str, key: str) -> np.ndarray:
    """One array of the npz, crc-checked when the manifest has a crc."""
    try:
        arr = data[meta["file"]]
    except Exception as e:
        raise CheckpointCorruptError(
            npz_path, f"array {meta['file']!r} (key {key!r}) unreadable "
                      f"({e})")
    want = meta.get("crc32")
    if want is not None and zlib.crc32(
            np.ascontiguousarray(arr).tobytes()) != want:
        raise CheckpointCorruptError(
            npz_path, f"array {meta['file']!r} (key {key!r}) crc mismatch")
    return arr


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step with a complete manifest."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        try:
            _read_manifest(os.path.join(ckpt_dir, name))
        except CheckpointCorruptError:
            continue
        found.append(int(name[len("step_"):]))
    return max(found) if found else None


def steps(ckpt_dir: str) -> list:
    """Every step present (complete or not), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n[len("step_"):]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_"))


def load_extra(ckpt_dir: str, step: int) -> dict:
    """The ``extra`` dict stored at save time ({} if absent)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    return _read_manifest(path).get("extra", {})


def _to_torch(arr: np.ndarray, stored: str, spec: ArraySpec,
              device: torch.device) -> torch.Tensor:
    want = _dtype_name(spec.dtype)
    if stored != want:
        raise ValueError(f"dtype mismatch: stored {stored}, want {want}")
    # np.ascontiguousarray makes a 0-dim array 1-dim: keep the shape
    if spec.dtype == torch.bfloat16:         # raw-stored bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(arr.shape).to(device)


def restore(ckpt_dir: str, step: int, target: Any, device=None,
            shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``target``, a tree of
    :class:`ArraySpec` leaves (or tensors or ``Sharded`` tensors, whose
    shape and dtype are taken).  Every array's crc32, shape and dtype are
    checked before it is placed: sharded over the ``NamedSpec`` at its key
    in ``shardings`` when there is one, else as a ``Sharded`` target leaf
    lays out its blocks, else on ``device`` (default: the card).  A crc
    mismatch raises :class:`CheckpointCorruptError`, a key the checkpoint
    lacks KeyError, a shape or dtype that differs ValueError."""
    flat_t = _flatten(target)
    placed = _flatten(shardings) if shardings is not None else {}
    dev = None
    if any(k not in placed and not isinstance(v, rules.Sharded)
           for k, v in flat_t.items()):
        dev = dispatch.resolve_device(device)
    tenant = _tenant(ckpt_dir)
    tr = obs_trace.tracer()
    t0 = tr.clock()
    reg = obs_metrics.registry()
    try:
        with tr.span("ckpt.restore", tenant=tenant, step=int(step)):
            out = _restore_body(ckpt_dir, step, target, dev, placed)
    except CheckpointCorruptError:
        reg.inc("ckpt_corrupt_total", tenant=tenant)
        raise
    reg.inc("ckpt_restores_total", tenant=tenant)
    reg.observe("ckpt_restore_latency_s", tr.clock() - t0, tenant=tenant)
    return out


def _restore_body(ckpt_dir: str, step: int, target: Any,
                  dev: Optional[torch.device], placed: dict) -> Any:
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    manifest = _read_manifest(path)
    npz_path = os.path.join(path, "arrays.npz")
    try:
        data = np.load(npz_path)
    except Exception as e:
        raise CheckpointCorruptError(npz_path,
                                     f"unreadable array container ({e})")
    out = {}
    with data:
        for key, spec in _flatten(target).items():
            named = placed.get(key)
            if isinstance(spec, rules.Sharded):
                named = named or spec.named()
            if isinstance(spec, (torch.Tensor, rules.Sharded)):
                spec = ArraySpec(tuple(spec.shape), spec.dtype)
            meta = manifest["keys"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing key {key}")
            arr = _checked_array(data, meta, npz_path, key)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(spec.shape)}")
            try:
                t = _to_torch(arr, meta["dtype"], spec,
                              torch.device("cpu") if named else dev)
            except ValueError as e:
                raise ValueError(f"{key}: {e}") from None
            out[key] = (rules.shard(t, named.spec, named.mesh) if named
                        else t)
    return _unflatten(target, out)


def _gc(ckpt_dir: str, keep: int) -> None:
    """Drop all but the last ``keep`` steps, but always keep the newest
    step that passes the cheap check, even if it is older than the
    window: deleting it would leave nothing on disk that restores."""
    all_steps = steps(ckpt_dir)
    kept = set(all_steps[-keep:]) if keep > 0 else set()

    def _ok(s: int) -> bool:
        try:
            verify(ckpt_dir, s, deep=False)
            return True
        except CheckpointCorruptError:
            return False

    if not any(_ok(s) for s in kept):
        for s in reversed(all_steps):
            if s not in kept and _ok(s):
                kept.add(s)            # the last verifiable one survives
                break
    for s in all_steps:
        if s not in kept:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                          ignore_errors=True)
