"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (pointers and the stream are
``c_void_p``).  The libraries land in ``<repo>/build/kernels/<hash>/``,
keyed by a hash of the sources and the flags, so an edited kernel never
loads a stale binary.  All sources compile in parallel (one ``nvcc`` per
file, started together).  Nothing builds at import time: the first caller
of :func:`library` pays for the build, and the serving engine calls it when
a shard is constructed, before its thread starts.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "packed_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Kernel launches made through one wrapper (thread-safe).  A wrapper
    adds one where it launches its kernel and nowhere else, so a run can
    show that the main path went through the kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library yet, all in
    parallel; returns name → library path.  Raises on any failure."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all sources on
    first use."""
    with _lock:
        if name not in _libs:
            for n, path in build_all().items():
                if n not in _libs:
                    lib = ctypes.CDLL(str(path))
                    lib.repro_error_string.argtypes = [ctypes.c_int]
                    lib.repro_error_string.restype = ctypes.c_char_p
                    _libs[n] = lib
        return _libs[name]


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its C signature declared (every
    launch function returns ``int``, a ``cudaError_t``)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function of
    ``csrc/<name>.cu``."""
    if err != 0:
        why = library(name).repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({why})")
