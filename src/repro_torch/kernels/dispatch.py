"""Where each op runs, and the launch counts that prove it.

The JAX package resolves kernel modes from the platform and env knobs
(``repro/kernels/dispatch.py:61-135``).  The port keeps one rule and no
kernel knobs: a tensor on a CUDA device goes to the hand-written kernel, a
tensor on the CPU goes to the kernel's plain PyTorch version.  Nothing
sends a CUDA tensor to the plain version -- a kernel that cannot build or
launch raises.  The one knob read here is the storage tier's,
``$REPRO_STORE_DTYPE`` (:func:`store_dtype`).

Entry points (index, segments, servables, the launcher) take a ``device``
argument resolved by :func:`resolve_device`: ``None`` means the card, and
with no card that raises instead of quietly running on the CPU.

``launches`` counts, per kernel, the launches its wrapper made -- one per
launch, counted by :func:`count_launch` right after the kernel was enqueued
and nowhere else -- so a run can show which kernels its main path went
through.  The count is taken under a lock: a maintenance worker and the
query thread launch kernels at once, and ``+= 1`` on a ``Counter`` is a
read-modify-write that threads can interleave.

A kernel launches on the calling thread's current CUDA device, so every
wrapper makes its launch inside :func:`on_device` of its input: on a
machine with several cards a sharded index keeps tensors on cards other
than the current one.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import Counter

import torch

KERNELS = ("hash_mm", "dct_mm", "fused_query", "merge", "quantized_query",
           "rerank", "simhash_pack")

# Sealed-segment storage precision tiers (``repro/kernels/dispatch.py:41``).
STORE_DTYPES = ("fp32", "bf16", "int8")

_ENV_STORE = "REPRO_STORE_DTYPE"

_SAME_DEVICE = contextlib.nullcontext()

launches: Counter = Counter({name: 0 for name in KERNELS})
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (wrappers call it right after
    enqueueing their kernel)."""
    with _launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _launches_lock:
        for name in KERNELS:
            launches[name] = 0


def store_dtype(override: str | None = None) -> str:
    """Resolve the sealed-segment storage tier: ``$REPRO_STORE_DTYPE`` >
    ``override`` (a tenant spec's ``precision``) > ``"fp32"``, as the JAX
    package's ``store_dtype``.  The operator's variable wins over the
    spec; the registry resolves it once, at registration, and records the
    result in the WAL REGISTER record and every snapshot, so recovery
    never reads the environment again."""
    mode = os.environ.get(_ENV_STORE) or override or "fp32"
    if mode not in STORE_DTYPES:
        raise ValueError(
            f"unknown store dtype {mode!r}; want one of {STORE_DTYPES}")
    return mode


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (``"cpu"``) or for shapes alone (``"meta"``: tensors that
    hold no memory, as the dry run sizes a cell; nothing computes there).
    Raises when the card is asked for (or implied) and absent.
    A card without an index is pinned to the calling thread's current one,
    so a worker thread that makes tensors on an index's device lands on
    that index's card, whatever the worker's own current device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type in ("cpu", "meta"):
        return dev
    raise ValueError(f"unsupported device {dev}; want 'cuda', 'cpu' or "
                     "'meta'")


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on unsupported device {t.device}")


def check_cuda_args(op: str, *tensors: torch.Tensor,
                    dtypes: tuple = ()) -> None:
    """Raise unless every tensor lies on one CUDA device, is contiguous and
    has the paired dtype (``dtypes[i]`` for ``tensors[i]``)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got {dev}")
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{op}: argument {i} on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: argument {i} is not contiguous")
        if i < len(dtypes) and t.dtype != dtypes[i]:
            raise TypeError(f"{op}: argument {i} is {t.dtype}, "
                            f"want {dtypes[i]}")


def on_device(t: torch.Tensor):
    """The context a ctypes launch on ``t`` runs in.  A kernel launches on
    the calling thread's current CUDA device, whatever stream it is handed,
    and ``allow_dynamic_smem_once`` (``csrc/common.cuh``) keys its opt-in on
    that device too; so a tensor on another card is launched under
    ``torch.cuda.device(t.device)``.  On the current device (every launch on
    a one-card machine) it is a no-op context, and the launch pays two
    device-index reads (the raw ones, as :func:`stream_handle` reads the
    stream: ``t`` is on a card, so CUDA is initialised)."""
    idx = t.get_device()
    if idx == torch._C._cuda_getDevice():
        return _SAME_DEVICE
    return torch.cuda.device(idx)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as an integer handle.
    Reads the raw handle (the call PyTorch's own compiled kernels launch
    with) rather than building a ``torch.cuda.Stream`` object per launch;
    it follows ``torch.cuda.stream(...)`` and graph capture alike."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
