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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "packed_prefill", "flash_attention",
           "ssd_scan", "fused_block", "mla_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Kernel launches made through one wrapper (thread-safe), in all and
    by variant.  A wrapper adds one where it launches its kernel and
    nowhere else, naming the variant it launched, so a run can show that
    the main path went through the kernel, and through which version."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.by_variant: Dict[str, int] = {}
        self._thread = threading.local()

    def add(self, variant: str, n: int = 1) -> None:
        """Count ``n`` launches of ``variant`` (a replayed CUDA graph adds
        the launches it holds; a negative ``n`` takes back a capture's)."""
        with self._lock:
            self.count += n
            left = self.by_variant.get(variant, 0) + n
            if left:
                self.by_variant[variant] = left
            else:
                self.by_variant.pop(variant, None)
        tally = getattr(self._thread, "tally", None)
        if tally is not None:
            tally[variant] = tally.get(variant, 0) + n

    def of(self, variant: str) -> int:
        """Launches of one variant since the last reset."""
        return self.by_variant.get(variant, 0)

    @contextlib.contextmanager
    def tally(self):
        """Yield a dict that counts, by variant, the launches the calling
        thread adds while the block runs (other threads' are not in it)."""
        outer = getattr(self._thread, "tally", None)
        self._thread.tally = counts = {}
        try:
            yield counts
        finally:
            self._thread.tally = outer

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_variant = {}


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


def _compile(out_dir: Path, names: Sequence[str], extra=()) -> Dict[str, str]:
    """Run one ``nvcc`` per source, all at once, into ``out_dir``; returns
    name → compiler output.  Raises on any failure."""
    nvcc = find_nvcc()
    procs = []
    for name in names:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors, logs = [], {}
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library yet, all in
    parallel; returns name → library path.  Raises on any failure."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if todo:
        _compile(out_dir, todo)
    return paths


def ptxas_report() -> Dict[str, str]:
    """Compile every source once more with ``-Xptxas -v`` (into
    ``build/kernels/ptxas/``, never loaded) and return name → the
    compiler's report: registers, shared memory and spill stores/loads of
    each kernel instance."""
    out_dir = BUILD_ROOT / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    return _compile(out_dir, SOURCES, extra=("-Xptxas", "-v"))


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


def call_on(device, fn, *args) -> int:
    """Call the launch function ``fn(*args, stream)`` on the current stream
    of ``device`` (a CUDA ``torch.device`` with an index), entering that
    device's context only when it is not already the current one: the
    context manager costs a few microseconds, and decode calls a kernel
    once a layer."""
    import torch
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function of
    ``csrc/<name>.cu``."""
    if err != 0:
        why = library(name).repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({why})")


def ptxas_summary(log: str):
    """(kernel instance, registers, spill store bytes, spill load bytes)
    for each entry function in one ``-Xptxas -v`` log, in order."""
    import re
    rows, entry, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            rows.append((entry, int(m.group(1))) + spill)
            entry, spill = None, (0, 0)
    return rows


if __name__ == "__main__":
    # python -m repro_torch.kernels.build: print each kernel's registers,
    # shared memory and spills (needs nvcc; run on the machine with the
    # card), then one line per kernel instance and the spill-free count
    rows = []
    for _name, _log in ptxas_report().items():
        print(f"== {_name}.cu\n{_log}")
        rows += ptxas_summary(_log)
    for _entry, _regs, _st, _ld in rows:
        print(f"{_regs:4d} registers, spill {_st}/{_ld} B  {_entry}")
    print(f"{sum(1 for r in rows if not r[2] and not r[3])} of {len(rows)} "
          f"kernel instances spill-free")
