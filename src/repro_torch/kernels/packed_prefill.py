"""Packed multi-prompt prefill attention: the hand-written Hopper kernel,
its wrapper and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/packed_prefill.py::packed_prefill_attention``
(+ ``_packed_kernel``).  The kernel is ``csrc/packed_prefill.cu``: one
block per (kv head, block of 16 lanes), walking only the segments that own
one of its lanes and, for each, only the pages below both ``seg_ctx`` and
its lanes' furthest position; fp32 online softmax under the
segment-indicator causal mask ``seg == si and key_pos <= pos``.  Padding
lanes (segment -1) are exactly 0.

Bound on H100: at the engine's chunk shapes (C = prefill_chunk_tokens +
max_batch lanes, a few hundred keys per segment) the kernel sits between
the rooflines; this first version does its products as fp32 FMAs from
shared memory, and its grid has only Hkv * ceil(C / 16) blocks.

Contract shared by both versions: ``seg_ctx[s]`` is at least one past the
largest position of segment ``s``'s lanes (the engine passes exactly
that), so page pruning by ``seg_ctx`` never hides a visible key.

Dispatch is by device: a CUDA tensor launches the kernel (or raises); a
CPU tensor runs :func:`packed_prefill_plain`.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k_pages, v_pages, page_rows, seg_ids, positions, seg_ctx, out;
# C, Hkv, G, D, page_size, n_segs, n_pages; scale; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def packed_prefill_plain(q, k_pages, v_pages, page_rows, seg_ids, positions,
                         seg_ctx=None):
    """The kernel's function in plain PyTorch, in the JAX package's
    production formulation (``repro/kernels/ops.py::_packed_xla``): every
    segment's page run laid end to end on one (S * s_max)-key axis and
    masked by key owner, which gathers S * s_max keys where the oracle
    gathers C * s_max.  Each key slot belongs to exactly one (segment,
    position), so segments sharing a physical page see their own copy."""
    del seg_ctx  # visibility is fully determined by (seg_ids, positions)
    c, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    s, npg = page_rows.shape
    s_max = npg * page_size
    t = s * s_max
    rows = page_rows.long()
    k_seq = k_pages[rows].reshape(t, hkv, d).float()
    v_seq = v_pages[rows].reshape(t, hkv, d).float()
    qf = q.reshape(c, hkv, g, d).float() * (1.0 / math.sqrt(d))
    sc = torch.einsum("ckgd,tkd->ckgt", qf, k_seq)
    key = torch.arange(t, device=q.device)
    allowed = (seg_ids.long()[:, None] == (key // s_max)[None, :]) & \
        ((key % s_max)[None, :] <= positions.long()[:, None])
    sc = sc.masked_fill(~allowed[:, None, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    # padding lanes (and lanes with nothing visible) match no key: pin
    # their NaN softmax to exactly zero
    p = torch.where(allowed.any(dim=1)[:, None, None, None], p, 0.0)
    out = torch.einsum("ckgt,tkd->ckgd", p, v_seq)
    return out.reshape(c, h, d).to(q.dtype)


def _check(q, k_pages, v_pages, page_rows, seg_ids, positions, seg_ctx):
    if q.dtype not in _DTYPES:
        raise TypeError(f"packed_prefill_attention: dtype {q.dtype} not "
                        f"supported (float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("packed_prefill_attention: q, k_pages and v_pages "
                        "must share one dtype")
    ints = (page_rows, seg_ids, positions, seg_ctx)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("packed_prefill_attention: page_rows, seg_ids, "
                        "positions and seg_ctx must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("packed_prefill_attention: need q (C,H,D) and "
                         "k/v_pages (P,page,Hkv,D) of one shape")
    c, h, d = q.shape
    _, _, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"packed_prefill_attention: head dims disagree "
                         f"(q {q.shape}, pages {k_pages.shape})")
    if page_rows.dim() != 2 or seg_ids.shape != (c,) or \
            positions.shape != (c,) or seg_ctx.shape != (page_rows.shape[0],):
        raise ValueError("packed_prefill_attention: need page_rows "
                         "(S,n_pages), seg_ids (C,), positions (C,) and "
                         "seg_ctx (S,)")
    tensors = (q, k_pages, v_pages) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError("packed_prefill_attention: all tensors must be on "
                         "one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed_prefill_attention: all tensors must be "
                         "contiguous")


def packed_prefill_cuda(q, k_pages, v_pages, page_rows, seg_ids, positions,
                        seg_ctx):
    """Launch ``csrc/packed_prefill.cu`` on the current stream."""
    _check(q, k_pages, v_pages, page_rows, seg_ids, positions, seg_ctx)
    c, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    n_segs, n_pages = page_rows.shape
    out = torch.empty_like(q)
    fn = build.function("packed_prefill", "packed_prefill_launch",
                        _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_rows.data_ptr(), seg_ids.data_ptr(),
                 positions.data_ptr(), seg_ctx.data_ptr(), out.data_ptr(),
                 c, hkv, h // hkv, d, page_size, n_segs, n_pages,
                 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    build.check("packed_prefill", err)
    launches.add()
    return out


def packed_prefill_attention(q, k_pages, v_pages, page_rows, seg_ids,
                             positions, seg_ctx):
    """q (C,H,D) packed chunk queries; k/v_pages (P,page,Hkv,D);
    page_rows (S,n_pages) int32 per-segment block-table rows; seg_ids (C,)
    int32 (-1 = padding lane); positions (C,) int32 absolute position of
    each lane in its own sequence; seg_ctx (S,) int32 per-segment context
    end (max position + 1; 0 for unused segments) → (C,H,D).

    K/V for every lane must already sit in the pages (the engine writes
    the chunk's keys/values before attending), so same-chunk causality
    comes straight from the page contents."""
    if q.is_cuda:
        return packed_prefill_cuda(q, k_pages, v_pages, page_rows, seg_ids,
                                   positions, seg_ctx)
    if q.device.type != "cpu":
        raise ValueError(f"packed_prefill_attention: no kernel for device "
                         f"{q.device}")
    return packed_prefill_plain(q, k_pages, v_pages, page_rows, seg_ids,
                                positions, seg_ctx)
