"""Paged-attention decode: the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::paged_attention``
(+ ``_paged_kernel``, ``_default_num_splits`` and the max/sum combine after
its ``pallas_call``).  The kernel is ``csrc/paged_attention.cu``: split-K
flash decoding, one block per (row, kv head, split) holding the row's G
query heads as one (G, D) tile and walking its split's pages through the
block table, then a second small kernel that combines the per-split
(acc, m, l) partials exactly as the TPU wrapper does.

Bound on H100: bytes.  A decode step reads every live key and value once
(B = 8, ctx = 1024, Hkv = 4, D = 64 in bf16: about 8.4 MB, about 2.5 us at
3.35 TB/s) and does only G = 8 query heads' worth of arithmetic per loaded
element, so the design spreads the bytes over enough blocks to keep all
132 SMs loading (the split count below) instead of spending effort on the
products.

Dispatch is by device: a CUDA tensor launches the kernel (or raises); a
CPU tensor runs :func:`paged_attention_plain`.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

N_SMS = 132          # H100 SXM
MAX_SPLITS = 128     # the combine kernel's shared weight array

launches = build.LaunchCounter()


def default_num_splits(batch: int, n_kv_heads: int, n_pages: int) -> int:
    """Split count for 132 SMs: enough (row, kv head, split) blocks for
    about two per SM, but at least four pages per split (a shorter split
    spends more on its partial write and the combine than it saves).  The
    TPU heuristic (``n_pages // 4`` capped at
    8) was sized for one TensorCore pair; at B = 8, Hkv = 4 there are only
    32 (row, kv head) pairs to spread over 132 SMs."""
    pairs = max(1, batch * n_kv_heads)
    want = -(-2 * N_SMS // pairs)
    return max(1, min(want, n_pages // 4, MAX_SPLITS))


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
    """Launch ``csrc/paged_attention.cu`` on the current stream."""
    _check(q, k_pages, v_pages, block_tables, context_lens, occupancy)
    b, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    if num_splits is None:
        num_splits = default_num_splits(b, hkv, n_pages)
    if not 1 <= num_splits <= MAX_SPLITS:
        raise ValueError(f"paged_attention: num_splits must be in "
                         f"[1, {MAX_SPLITS}], got {num_splits}")
    pages_per_split = -(-n_pages // num_splits)
    g = h // hkv
    dev = q.device
    acc = torch.empty((num_splits, b, hkv, g, d), dtype=torch.float32,
                      device=dev)
    m = torch.empty((num_splits, b, hkv, g), dtype=torch.float32, device=dev)
    l = torch.empty((num_splits, b, hkv, g), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = build.function("paged_attention", "paged_attention_launch",
                        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), context_lens.data_ptr(),
                 occupancy.data_ptr(), acc.data_ptr(), m.data_ptr(),
                 l.data_ptr(), out.data_ptr(), b, hkv, g, d, page_size,
                 n_pages, num_splits, pages_per_split, 1.0 / math.sqrt(d),
                 _DTYPES[q.dtype], stream)
    build.check("paged_attention", err)
    launches.add()
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
