"""Paged-attention decode: the hand-written Hopper kernels, their wrapper
and the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::paged_attention``
(+ ``_paged_kernel``, ``_default_num_splits`` and the max/sum combine after
its ``pallas_call``).  The kernels are in ``csrc/paged_attention.cu``:
split-K flash decoding, one block per (row, kv head, split) holding the
row's G query heads as one tile and walking its split's pages through the
block table, then a merge of the per-split (acc, m, l) partials exactly as
the TPU wrapper combines them.

Bound on H100: bytes, and at the serving batch the latency of getting
them.  A decode step reads every live key and value once (B = 8 rows of
up to 1024 keys, Hkv = 4, D = 64 in bf16: about 3 MB, under 1 us at
3.35 TB/s) and does only G = 8 query heads' worth of arithmetic per loaded
element.  Two variants, chosen openly by :func:`kernel_variant`:

* ``"mma"`` — bf16 with D in :data:`TC_HEAD_DIMS` and G <= :data:`TC_MAX_GROUP`
  (TinyLlama, Qwen3, Llama-3).  Each warp copies its own 16-key slices by
  16-byte ``cp.async`` into a three-stage bf16 ring (every copy of a block
  in flight before it computes), Q Kᵀ and P V on the tensor cores
  (``mma.sync`` m16n8k16, the G query heads as M), fp32 online softmax in
  registers.  The splits of one (row, kv head), at most
  :data:`TC_MAX_SPLITS`, run as one thread-block cluster and merge in its
  distributed shared memory in the same launch, so the call needs no
  scratch.  Needs 16-byte-aligned tensors.
* ``"fma"`` — fp32 (not yet redesigned, ROADMAP B.1: the 3xTF32 split
  that flash and packed prefill use for fp32 would keep its accuracy on
  the tensor cores) and bf16 at any other shape: the first version, fp32
  FMAs from shared memory and a second combine kernel over one scratch
  allocation of partials.

The wrapper enters no device context when the tensor's device is current
and checks only metadata (no device sync); the fma variant's scratch is
the call's own, so shards on threads and streams share nothing.

Dispatch is by device: a CUDA tensor launches one of the two (or raises); a
CPU tensor runs :func:`paged_attention_plain`.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

N_SMS = 132          # H100 SXM
MAX_SPLITS = 128     # the combine kernels' shared weight arrays
TC_HEAD_DIMS = (64, 128)
TC_MAX_GROUP = 16    # query heads of one kv head: the mma's 16 M rows
TC_MAX_SPLITS = 8    # the mma variant's splits form one cluster (portable)

launches = build.LaunchCounter()


def kernel_variant(dtype, head_dim: int, group: int, device) -> str:
    """The version that serves a call: ``"plain"`` on the CPU; on a CUDA
    device ``"mma"`` for bf16 with D in :data:`TC_HEAD_DIMS` and
    G = H / Hkv <= :data:`TC_MAX_GROUP`, else ``"fma"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {device}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS and \
            group <= TC_MAX_GROUP:
        return "mma"
    return "fma"


def max_splits(variant: str) -> int:
    """The most splits a variant runs: :data:`TC_MAX_SPLITS` for ``"mma"``
    (its splits are one thread-block cluster), :data:`MAX_SPLITS` for
    ``"fma"`` (its combine kernel's weight arrays)."""
    return TC_MAX_SPLITS if variant == "mma" else MAX_SPLITS


def default_num_splits(batch: int, n_kv_heads: int, n_pages: int,
                       variant: str) -> int:
    """Split count for 132 SMs: enough (split, row, kv head) blocks for
    about two per SM, but at least four pages per split (a shorter split
    spends more on its partial and the merge than it saves), and at most
    :func:`max_splits` of the variant.  The TPU heuristic (``n_pages // 4``
    capped at 8) was sized for one TensorCore pair; at B = 8, Hkv = 4 there
    are only 32 (row, kv head) pairs to spread over 132 SMs.  At B = 1,
    Hkv = 4 the mma variant's cap of 8 leaves 32 blocks on the card."""
    pairs = max(1, batch * n_kv_heads)
    want = -(-2 * N_SMS // pairs)
    return max(1, min(want, n_pages // 4, max_splits(variant)))


def paged_splits(batch: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 n_pages: int, dtype, device):
    """The split count a call of ``batch`` rows runs by default on
    ``device``, to pass on as ``num_splits`` where another call must sum
    its rows in the same order; None on the CPU (no splits there)."""
    variant = kernel_variant(dtype, head_dim, n_heads // n_kv_heads, device)
    if variant == "plain":
        return None
    return default_num_splits(batch, n_kv_heads, n_pages, variant)


def split_count(num_splits, batch: int, n_kv_heads: int, n_pages: int,
                variant: str) -> int:
    """The splits a call runs: :func:`default_num_splits` for ``None``; an
    explicit count in [1, :func:`max_splits`] as asked, and above it a
    ``ValueError`` (the count is never cut quietly)."""
    if num_splits is None:
        return default_num_splits(batch, n_kv_heads, n_pages, variant)
    most = max_splits(variant)
    if not 1 <= num_splits <= most:
        raise ValueError(f"paged_attention: num_splits must be in [1, "
                         f"{most}] for the {variant} variant, got "
                         f"{num_splits}")
    return num_splits


def scratch_floats(batch: int, n_kv_heads: int, group: int, head_dim: int,
                   num_splits: int) -> int:
    """fp32 words of the fma variant's one scratch, whose combine kernel
    merges the splits through global memory: the per-split partial acc
    (splits x B x Hkv x G x D), then all m, then all l."""
    return num_splits * batch * n_kv_heads * group * (head_dim + 2)


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          occupancy=None):
    """The kernel's function in plain PyTorch: the oracle
    :func:`repro_torch.kernels.ref.paged_attention_ref`, with a row that has
    no visible key (``context_lens`` 0) treated as unoccupied, so it is
    exactly 0 as in the kernel instead of NaN."""
    live = context_lens > 0
    if occupancy is not None:
        live = live & occupancy
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, occupancy=live)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k_pages, v_pages, block_tables, context_lens, occupancy, acc, m, l,
# out; B, Hkv, G, D, page_size, n_pages, num_splits, pages_per_split;
# scale; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# q, k_pages, v_pages, block_tables, context_lens, occupancy, out; B, Hkv,
# G, D, page_size, n_pages, num_splits, pages_per_split; scale; stream
_MMA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]


def _check(q, k_pages, v_pages, block_tables, context_lens, occupancy):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        "one dtype")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens must "
                        "be int32")
    if occupancy.dtype != torch.bool:
        raise TypeError("paged_attention: occupancy must be bool")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: need q (B,H,D) and k/v_pages "
                         "(P,page,Hkv,D) of one shape")
    b, h, d = q.shape
    _, _, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"paged_attention: head dims disagree (q {q.shape}, "
                         f"pages {k_pages.shape})")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            context_lens.shape != (b,) or occupancy.shape != (b,):
        raise ValueError("paged_attention: block_tables (B,n_pages), "
                         "context_lens (B,) and occupancy (B,) must match q")
    tensors = (q, k_pages, v_pages, block_tables, context_lens, occupancy)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: all tensors must be contiguous")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, context_lens,
                         occupancy, num_splits=None):
    """Launch the variant of ``csrc/paged_attention.cu`` that
    :func:`kernel_variant` names, on the current stream, with the splits
    of :func:`split_count`."""
    _check(q, k_pages, v_pages, block_tables, context_lens, occupancy)
    b, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    g = h // hkv
    dev = q.device
    variant = kernel_variant(q.dtype, d, g, dev)
    num_splits = split_count(num_splits, b, hkv, n_pages, variant)
    pages_per_split = -(-n_pages // num_splits)
    out = torch.empty_like(q)
    if b == 0:
        return out
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            occupancy.data_ptr()]
    dims = [b, hkv, g, d, page_size, n_pages, num_splits, pages_per_split,
            1.0 / math.sqrt(d)]
    if variant == "mma":
        if any(p % 16 for p in ptrs[:3] + [out.data_ptr()]):
            raise ValueError("paged_attention: the bf16 tensor-core kernel "
                             "needs 16-byte-aligned tensors (cp.async)")
        fn = build.function("paged_attention", "paged_attention_mma_launch",
                            _MMA_ARGTYPES)
        args = ptrs + [out.data_ptr()] + dims
    else:
        # one scratch: the partial acc, then all m, then all l
        n_rows = num_splits * b * hkv * g
        scratch = torch.empty((scratch_floats(b, hkv, g, d, num_splits),),
                              dtype=torch.float32, device=dev)
        acc = scratch.data_ptr()
        fn = build.function("paged_attention", "paged_attention_launch",
                            _ARGTYPES)
        args = ptrs + [acc, acc + 4 * n_rows * d, acc + 4 * n_rows * (d + 1),
                       out.data_ptr()] + dims + [_DTYPES[q.dtype]]
    build.check("paged_attention", build.call_on(dev, fn, *args))
    launches.add(variant)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    occupancy=None, num_splits=None):
    """q (B,H,D); k/v_pages (P,page,Hkv,D); block_tables (B,n_pages) int32;
    context_lens (B,) int32; occupancy (B,) bool optional (False rows are
    batch padding: output exactly 0) → (B,H,D).

    CUDA tensors launch the kernel; CPU tensors run the plain version
    (which has no split dimension and ignores ``num_splits``)."""
    if q.is_cuda:
        if occupancy is None:
            occupancy = torch.ones(q.shape[0], dtype=torch.bool,
                                   device=q.device)
        return paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                    context_lens, occupancy, num_splits)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens, occupancy)
