"""Mamba2 SSD chunk scan: the hand-written Hopper kernels, their wrapper and
the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(+ ``_ssd_kernel``).  The kernels are in ``csrc/ssd_scan.cu``: one block
per (batch, head) walking the chunks in order with the fp32 (P, N) state,
the decay-masked C·Bᵀ dual form of each chunk taken only on and below the
diagonal, and ``d_skip`` folded into the fp32 epilogue before the cast
(where the model's ``ssd_chunked_ref`` adds it; the JAX dispatch
``ops.ssd`` adds it after the kernel's cast instead).  S need not be a
multiple of the chunk: the ragged last chunk is masked in the kernel.

Bound on H100: bytes.  At the Mamba2 block's shape (B = 4, S = 1024,
H = 64, P = 64, N = 128, bf16) a call moves about 78 MB (x, B, C, dt in;
y and the fp32 final state out) against about 15 GFLOP of chunk products.
Two variants, chosen openly by :func:`kernel_variant`:

* ``"mma"`` — bf16 x/B/C with P = 64, N in :data:`TC_STATES` and chunk
  :data:`TC_CHUNK` (Mamba2-1.3B and Zamba2-1.2B).  All four chunk products
  (C·stateᵀ, C·Bᵀ, the decayed scores times x, and the state update
  xᵀ·(B∘w)) on the tensor cores with ``mma.sync``; the scores rounded to
  bf16 before they multiply x, the carried state fp32 in registers and
  bf16 only as an operand; x, B and C in bf16 shared memory by 16-byte
  ``cp.async``, two blocks an SM.  Needs 16-byte-aligned x, B, C and y.
* ``"fma"`` — fp32 (not yet redesigned, ROADMAP B.4: the 3xTF32 split
  that flash and packed prefill use for fp32 would keep its accuracy on
  the tensor cores) and bf16 at any other shape: the first version, fp32
  FMAs from shared memory.

Dispatch is by device: a CUDA tensor launches one of the two (or raises); a
CPU tensor runs :func:`ssd_scan_plain`, and so does a ``meta`` tensor (the
dry run's abstract device).  There is no fallback.  DTensor inputs run on
their local shards through ``local_map`` (:mod:`.sharded`), sharded at
most over batch and heads (with the groups).

Gradients: the kernels are forward-only, as the TPU kernel is (the JAX
trainer differentiates ``ref.ssd_chunked_ref``).  Under autograd a CUDA
call goes through :class:`SSDScanFn`: the kernel forward, and the
vector-Jacobian product of :func:`ssd_scan_plain` at the saved inputs
(recomputed) for x, dt, a, b, c and d_skip.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.dtensor_ops import is_dtensor, run_local
from . import build, ref, sharded

MAX_CHUNK = 128   # the kernel's score strips cover 128 key columns
MAX_HEAD_DIM = 128   # P
MAX_STATE = 128      # N
TC_HEAD_DIM = 64     # P of the mma variant
TC_STATES = (64, 128)
TC_CHUNK = 128

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, dt, a, b, c, d_skip, y, final_state; B, S, H, G, P, N, Q; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# x, dt, a, b, c, d_skip, y, final_state; B, S, H, G, N; stream
_MMA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]


def kernel_variant(dtype, head_dim: int, state: int, chunk: int,
                   device) -> str:
    """The version that serves a call: ``"plain"`` on the CPU; on a CUDA
    device ``"mma"`` for bf16 with P = :data:`TC_HEAD_DIM`, N in
    :data:`TC_STATES` and chunk :data:`TC_CHUNK`, else ``"fma"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {device}")
    if dtype == torch.bfloat16 and head_dim == TC_HEAD_DIM and \
            state in TC_STATES and chunk == TC_CHUNK:
        return "mma"
    return "fma"


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
    """Launch the variant of ``csrc/ssd_scan.cu`` that
    :func:`kernel_variant` names, on the current stream.  dt, a and d_skip
    are read in fp32 (a bf16 value widens exactly)."""
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
    variant = kernel_variant(x.dtype, p, n, chunk, x.device)
    ptrs = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if d_skip is None else d_skip.data_ptr(),
            y.data_ptr(), final.data_ptr()]
    if variant == "mma":
        if any(t.data_ptr() % 16 for t in (x, b, c, y)):
            raise ValueError("ssd_scan: the bf16 tensor-core kernel needs "
                             "16-byte-aligned x, b, c and y (cp.async)")
        fn = build.function("ssd_scan", "ssd_scan_mma_launch", _MMA_ARGTYPES)
        args = ptrs + [bsz, s, h, g, n]
    else:
        fn = build.function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
        args = ptrs + [bsz, s, h, g, p, n, max(1, min(chunk, s)),
                       _DTYPES[x.dtype]]
    build.check("ssd_scan", build.call_on(x.device, fn, *args))
    launches.add(variant)
    return y, final


class SSDScanFn(torch.autograd.Function):
    """``forward(x, dt, a, b, c, chunk=, d_skip=)`` (the kernel, or for a
    CPU test of the backward's plumbing the plain version) with the plain
    version's gradient: the backward recomputes :func:`ssd_scan_plain` on
    the saved inputs and returns its vector-Jacobian product for y's and
    the final state's incoming gradients (either may be None: the models
    discard the final state), each in its input's dtype.  Call as
    ``SSDScanFn.apply(x, dt, a, b, c, d_skip, chunk, forward)``."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk, forward):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        ctx.chunk = chunk
        return forward(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)

    @staticmethod
    def backward(ctx, dy, dfinal):
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            outs = ssd_scan_plain(*ins[:5], chunk=ctx.chunk, d_skip=ins[5])
            pairs = [(o, g) for o, g in zip(outs, (dy, dfinal))
                     if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t, n in zip(ins, need) if n],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, d_skip=None):
    """x (B,S,H,P); dt (B,S,H); a (H,) negative; b/c (B,S,G,N); d_skip (H,)
    optional → (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).

    CUDA tensors launch the kernel (through :class:`SSDScanFn` when grad
    mode is on and an input requires grad); CPU and ``meta`` tensors run
    the plain version; DTensors run the same on their local shards
    (:func:`_ssd_sharded`)."""
    if is_dtensor(x):
        return _ssd_sharded(x, dt, a, b, c, chunk, d_skip)
    if x.is_cuda:
        ins = (x, dt, a, b, c, d_skip)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ins):
            return SSDScanFn.apply(*ins, chunk, ssd_scan_cuda)
        return ssd_scan_cuda(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)


def _ssd_sharded(x, dt, a, b, c, chunk, d_skip):
    """The scan of DTensors on their local shards: each mesh dimension
    keeps x's batch or head split where the sizes allow it (heads only
    with the groups split alike, or a single group replicated) and
    replicates otherwise; dt, a, b, c, d_skip and the outputs follow."""
    bsz, _, h, _ = x.shape
    g = b.shape[2]
    dims = sharded.split_dims(
        x, (0, 2), lambda d, n: bsz % n == 0 if d == 0 else
        h % n == 0 and (g % n == 0 or g == 1))
    heads = {0: None, 2: 0, None: None}         # a, d_skip: (H,)
    groups = {0: 0, 2: None if g == 1 else 2, None: None}
    final = {0: 0, 2: 1, None: None}            # (B, H, P, N)
    vec = [heads[d] for d in dims]
    return run_local(
        lambda x, dt, a, b, c, d: ssd_scan(
            x.contiguous(), dt, a, b.contiguous(), c.contiguous(),
            chunk=chunk, d_skip=d),
        (x, dt, a, b, c, d_skip),
        (dims, dims, vec, [groups[d] for d in dims],
         [groups[d] for d in dims], None if d_skip is None else vec),
        (dims, [final[d] for d in dims]), x.device_mesh)
