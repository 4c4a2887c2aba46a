"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file becomes its own shared library with a plain C
interface (device pointers and the stream as ``void*``), compiled for
Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<digest>.so <name>.cu

on first use, into ``build/repro_torch/`` at the root of the checkout.  The
file name carries a digest of the sources and flags, so an edited kernel is
rebuilt and a stale library is never loaded.  :func:`build` compiles every
missing library at once, one nvcc process per source, all started together.
A failed build raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel library name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels cannot be built")


def _digest(src: Path) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(sources()[name])}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all) in
    parallel and load them.  Returns seconds spent per compiled library
    (empty when everything was already built)."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        spent: Dict[str, float] = {}
        if todo:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            t0 = time.perf_counter()
            for n in todo:
                out = _target(n)
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(srcs[n])]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True), tmp, out)
            failed = []
            for n, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                spent[n] = time.perf_counter() - t0
                out.with_suffix(".log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"--- {n} (exit {proc.returncode}) ---\n"
                                  f"{log}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)   # atomic: readers never see a
                    # half-written library
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_target(n)))
    return spent


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of ``name`` in this checkout, or '' if it was not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} launch failed: CUDA error {code} "
            f"({fn(code).decode()})")
