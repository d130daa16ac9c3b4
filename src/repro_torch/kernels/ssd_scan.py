"""Mamba2 SSD chunk scan: the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(+ ``_ssd_kernel``).  The kernel is ``csrc/ssd_scan.cu``: one block per
(batch, head) walking the chunks in order with the fp32 (P, N) state in
shared memory, the decay-masked C·Bᵀ dual form of each chunk built in
strips of 32 query rows, and ``d_skip`` folded into the fp32 epilogue
before the cast (where the model's ``ssd_chunked_ref`` adds it; the JAX
dispatch ``ops.ssd`` adds it after the kernel's cast instead).  S need not
be a multiple of the chunk: the ragged last chunk is masked in the kernel.

Bound on H100: operations (the chunk's score strips and state products,
about 2 * B * S * H * (Q N + Q P + 2 P N) of them, against one read of x,
B and C and one write of y).  This first version computes with fp32 FMAs
from shared memory; its grid is B * H blocks.

Dispatch is by device: a CUDA tensor launches the kernel (or raises); a
CPU tensor runs :func:`ssd_scan_plain`.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

MAX_CHUNK = 128   # the kernel's score strips cover 128 key columns
MAX_HEAD_DIM = 128   # P
MAX_STATE = 128      # N

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, dt, a, b, c, d_skip, y, final_state; B, S, H, G, P, N, Q; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128, d_skip=None):
    """The kernel's function in plain PyTorch: the chunked dual form
    :func:`repro_torch.kernels.ref.ssd_chunked_ref` (the model's SSD,
    ``d_skip`` added in fp32 before the cast)."""
    return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)


def _check(x, dt, a, b, c, chunk, d_skip):
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: dtype {x.dtype} not supported (float32 "
                        f"or bfloat16)")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssd_scan: x, b and c must share one dtype")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError("ssd_scan: need x (B,S,H,P) and b/c (B,S,G,N) of "
                         "one shape")
    bsz, s, h, p = x.shape
    _, _, g, n = b.shape
    if b.shape[:2] != (bsz, s) or h % g:
        raise ValueError(f"ssd_scan: shapes disagree (x {x.shape}, b "
                         f"{b.shape})")
    if dt.shape != (bsz, s, h) or a.shape != (h,) or \
            (d_skip is not None and d_skip.shape != (h,)):
        raise ValueError("ssd_scan: need dt (B,S,H), a (H,) and d_skip (H,)")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"ssd_scan: head dim {p} or state {n} above "
                         f"{MAX_HEAD_DIM}")
    tensors = [x, dt, a, b, c] + ([] if d_skip is None else [d_skip])
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: all tensors must be on one device")
    if not all(t.is_contiguous() for t in (x, b, c)):
        raise ValueError("ssd_scan: x, b and c must be contiguous")


def ssd_scan_cuda(x, dt, a, b, c, *, chunk: int = 128, d_skip=None):
    """Launch ``csrc/ssd_scan.cu`` on the current stream.  dt, a and
    d_skip are read in fp32 (a bf16 value widens exactly)."""
    _check(x, dt, a, b, c, chunk, d_skip)
    bsz, s, h, p = x.shape
    _, _, g, n = b.shape
    dt = dt.float().contiguous()
    a = a.float().contiguous()
    if d_skip is not None:
        d_skip = d_skip.float().contiguous()
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return y, final
    q = max(1, min(chunk, s))
    fn = build.function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), None if d_skip is None else d_skip.data_ptr(),
                 y.data_ptr(), final.data_ptr(), bsz, s, h, g, p, n, q,
                 _DTYPES[x.dtype], stream)
    build.check("ssd_scan", err)
    launches.add("fma")
    return y, final


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, d_skip=None):
    """x (B,S,H,P); dt (B,S,H); a (H,) negative; b/c (B,S,G,N); d_skip (H,)
    optional → (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
