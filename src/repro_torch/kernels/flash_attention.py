"""Dense attention forward: the hand-written Hopper kernels, their wrapper
and the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(+ ``_flash_kernel``).  The kernels are in ``csrc/flash_attention.cu``;
both take one block per (tile of 64 query rows, head, batch), walk key
tiles of 64 only up to the diagonal when causal, read kv head
``h / group`` (GQA without copying K/V) and keep an fp32 online softmax.
Any Sq and Sk work: the ragged tails are masked in the kernel, where the
TPU dispatch asked for ``Sq % block_q == 0``.

Causal alignment: the TPU kernel aligns the mask top-left (query i sees
keys 0..i), the JAX oracle bottom-right (``tril(k=Sk - Sq)``).  The two
agree only when Sq == Sk, which is every model call, so ``causal=True``
accepts Sq == Sk only and raises otherwise.

Bound on H100: operations.  At the models' shapes (S = 1000–1024, D = 64)
the causal product is about 4 * B * H * S^2 / 2 * D operations against a
few MB of q, k, v and out.  At DeepSeek-V2's MLA prefill (B = 2, S = 1024,
H = 128, D = 192) the two come close in bf16: 403 MB take 0.120 ms at
3.35 TB/s, 1.03e11 operations 0.104 ms at 989 TFLOP/s.  Three variants,
chosen openly by :func:`kernel_variant` from the dtype and the head dim:

* ``"wgmma"`` — bf16 with D in :data:`TC_HEAD_DIMS` (every config that
  reaches this kernel: TinyLlama and Zamba2 use 64, OLMoE, Qwen3 and
  Llama-3 128, DeepSeek-V2's MLA 192, nope 128 + rope 64 with V padded).
  QK^T and PV on the tensor cores (wgmma), Q/K/V tiles by TMA into a
  ring of two stages (three at D = 192); one or two consumer warpgroups
  a block, 64 query rows each (:func:`query_rows`).  Needs
  16-byte-aligned tensors (TMA).
* ``"tf32x3"`` — fp32 with D in :data:`TC_HEAD_DIMS`.  The same tiling on
  ``mma.sync`` with each operand split in two TF32 numbers (3xTF32:
  fp32's accuracy, within the 3e-5 tolerance, at the TF32 rate), K/V by
  ``cp.async``.  Needs 16-byte-aligned tensors.
* ``"fma"`` — fp32 and bf16 with any other D: the first version, fp32
  FMAs from shared memory.

Dispatch is by device: a CUDA tensor launches one of the variants (or
raises); a CPU tensor runs :func:`flash_attention_plain`, and so does a
``meta`` tensor (the dry run's abstract device, where nothing runs).
There is no fallback.  DTensor inputs run on their local shards through
``local_map`` (:mod:`.sharded`), sharded at most over batch and heads
(with GQA's kv heads whole where they do not split as far as the q
heads).

Gradients: the kernels are forward-only, as the TPU kernel is (the JAX
trainer differentiates the jnp mirror ``layers.blockwise_attention``).
Under autograd a CUDA call goes through :class:`FlashAttentionFn`, whose
forward is the kernel and whose backward is the vector-Jacobian product
of :func:`flash_attention_plain` at the saved inputs (recomputed), so a
trainer's attention forward runs on the card's kernel and every input
gets its gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.dtensor_ops import is_dtensor, local_rank, run_local
from . import build, ref, sharded

MAX_HEAD_DIM = 192   # the FMA kernel's register tile covers D <= 192
TC_HEAD_DIMS = (64, 128, 192)

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out; B, Sq, Sk, H, Hkv, D, causal; scale; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# the tensor-core variants: no dtype (one entry point each), rows instead
_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_TC_SYMBOLS = {"wgmma": "flash_attention_tc_launch",
               "tf32x3": "flash_attention_tf32x3_launch"}


def kernel_variant(dtype, head_dim: int, device) -> str:
    """The version that serves a call: ``"plain"`` on the CPU; on a CUDA
    device ``"wgmma"`` for bf16 and ``"tf32x3"`` for fp32 with D in
    :data:`TC_HEAD_DIMS`, else ``"fma"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    if head_dim in TC_HEAD_DIMS:
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "fma"


def query_rows(head_dim: int) -> int:
    """Query rows of one block of a tensor-core variant: 64 (one bf16
    warpgroup, or 4 fp32 warps) at D = 64, 128 (two warpgroups, or 8
    warps, sharing each K/V stage) at D = 128 and 192, in either dtype:
    the faster tile of each D in ``chip_smoke.py`` phase 7, which times
    both by patching this function (PERF.md section 6)."""
    return 64 if head_dim == 64 else 128


def _check_causal(q, k, causal: bool) -> None:
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention: causal=True needs Sq == Sk (got Sq "
            f"{q.shape[1]}, Sk {k.shape[1]}): the kernel aligns the mask "
            f"top-left and the oracle bottom-right, which agree only then")


def flash_attention_plain(q, k, v, *, causal: bool):
    """The kernel's function in plain PyTorch: the oracle
    :func:`repro_torch.kernels.ref.flash_attention_ref` (fp32 softmax, the
    scale applied to q in fp32), under the kernel's causal contract."""
    _check_causal(q, k, causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)


def _check(q, k, v, causal):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: need q (B,Sq,H,D) and k/v "
                         "(B,Sk,Hkv,D) of one shape")
    b, sq, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d or h % hkv:
        raise ValueError(f"flash_attention: shapes disagree (q {q.shape}, "
                         f"k {k.shape})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if sk < 1:
        raise ValueError("flash_attention: need at least one key")
    _check_causal(q, k, causal)
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all tensors must be on one "
                         "device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: all tensors must be contiguous")


def flash_attention_cuda(q, k, v, *, causal: bool):
    """Launch the variant of ``csrc/flash_attention.cu`` that
    :func:`kernel_variant` names, on the current stream (a tensor-core
    variant with the tile :func:`query_rows` names)."""
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    variant = kernel_variant(q.dtype, d, q.device)
    if variant in _TC_SYMBOLS:
        if any(t.data_ptr() % 16 for t in (q, k, v, out)):
            raise ValueError(f"flash_attention: the {variant} kernel needs "
                             f"16-byte-aligned tensors (TMA, cp.async)")
        fn = build.function("flash_attention", _TC_SYMBOLS[variant],
                            _TC_ARGTYPES)
        extra = (query_rows(d),)
    else:
        fn = build.function("flash_attention", "flash_attention_launch",
                            _ARGTYPES)
        extra = (_DTYPES[q.dtype],)
    err = build.call_on(q.device, fn, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), b, sq, sk, h, hkv, d,
                        int(causal), 1.0 / math.sqrt(d), *extra)
    build.check("flash_attention", err)
    launches.add(variant)
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``forward(q, k, v, causal)`` (the kernel, or for a CPU test of the
    backward's plumbing the plain version) with the plain version's
    gradient: the backward recomputes :func:`flash_attention_plain` on the
    saved inputs and returns its vector-Jacobian product, in each input's
    dtype.  Call as ``FlashAttentionFn.apply(q, k, v, causal, forward)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, forward):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return forward(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = flash_attention_plain(*ins, causal=ctx.causal)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], dout))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def flash_attention(q, k, v, *, causal: bool):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) → (B,Sq,H,D) in q's dtype; fp32
    online softmax with scale 1/sqrt(D).  ``causal=True`` needs Sq == Sk.

    CUDA tensors launch the kernel (through :class:`FlashAttentionFn`
    when grad mode is on and an input requires grad); CPU and ``meta``
    tensors run the plain version; DTensors run the same on their local
    shards (:func:`_flash_sharded`)."""
    if is_dtensor(q):
        return _flash_sharded(q, k, v, causal)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal,
                                          flash_attention_cuda)
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal)


def _flash_sharded(q, k, v, causal: bool):
    """Attention of DTensors on their local shards: each mesh dimension
    keeps q's batch or head split where the sizes allow it and replicates
    otherwise.  Heads split alike over q and k / v where Hkv divides;
    where only H does and each rank's q heads lie in one kv group (GQA's
    few kv heads: TinyLlama's 4 over 16 ways), k / v enter whole on the
    head split and each rank attends its one kv head
    (:func:`sharded.gqa_local`).  The output follows q."""
    b, _, h, _ = q.shape
    hkv = k.shape[2]
    dims = sharded.split_dims(
        q, (0, 2), lambda d, n: b % n == 0 if d == 0 else
        h % n == 0 and (hkv % n == 0 or (h // hkv) % (h // n) == 0))
    rank, ways = local_rank(
        q.device_mesh, [i for i, d in enumerate(dims) if d == 2])
    if hkv % ways == 0:
        return run_local(
            lambda q, k, v: flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=causal),
            (q, k, v), (dims, dims, dims), (dims,), q.device_mesh)
    kv = [None if d == 2 else d for d in dims]
    return run_local(
        lambda q, k, v: sharded.gqa_local(q, k, v, rank, ways, causal),
        (q, k, v), (dims, kv, kv), (dims,), q.device_mesh)
