"""Packed multi-prompt prefill attention: the hand-written Hopper kernels,
their wrapper and the plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/packed_prefill.py::packed_prefill_attention``
(+ ``_packed_kernel``).  Both kernels in ``csrc/packed_prefill.cu`` keep
the segment-indicator causal mask ``seg == si and key_pos <= pos``, read
no page at or past ``seg_ctx``, let segments share physical pages, and
write padding lanes (segment -1) and lanes with nothing visible as exactly
0.

Bound on H100: bytes, at about 0.002 ms for the engine's chunk; what sets
the time there is latency and the schedule (the longest chain of key tiles
one block walks, and how many SMs have work).  Three variants, chosen
openly by :func:`kernel_variant` from the dtype, the head dim and the
group:

* ``"wgmma"`` — bf16 with D in :data:`TC_HEAD_DIMS` and G = H / Hkv <= 64.
  A device-side planner splits the chunk into work items (lane block,
  segment, key range) of at most :func:`item_keys` keys; blocks of one
  warpgroup gather each item's K/V pages with ``cp.async`` and run QK^T and
  PV on the tensor cores for a 64-row tile (:func:`lanes_per_block` lanes
  x G heads of one kv head), writing fp32 (acc, m, l) partials to scratch
  that this wrapper allocates; a combine kernel merges them per row.  The
  grid and the scratch are sized from the shapes alone
  (:func:`work_bounds`), so the engine gains no device-to-host copy.
* ``"tf32x3"`` — fp32 at the shapes ``"wgmma"`` takes: the same planner,
  work items, scratch and combine kernel; the partial kernel gathers fp32
  K/V rows by ``cp.async`` and runs QK^T and PV on ``mma.sync`` with each
  operand split in two TF32 numbers (3xTF32: fp32's accuracy, within the
  3e-5 tolerance, at the TF32 rate).
* ``"fma"`` — fp32 and bf16 at any other D or G: the first version, one
  block per (kv head, 16 lanes) walking its segments one after another,
  fp32 FMAs.

Contract shared by all versions: ``seg_ctx[s]`` is at least one past the
largest position of segment ``s``'s lanes (the engine passes exactly
that), so page pruning by ``seg_ctx`` never hides a visible key.

Dispatch is by device: a CUDA tensor launches a kernel (or raises); a CPU
tensor runs :func:`packed_prefill_plain`.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .paged_attention import N_SMS

TC_HEAD_DIMS = (64, 128)
TC_ROWS = 64             # query rows of one warpgroup tile
KEYS_PER_ITEM = 256      # key range of one work item, at most ...
MAX_RANGES = 8           # ... until a segment of n_pages would need more
TC_BLOCKS_PER_SM = 4     # partial-kernel blocks an SM (bf16: all resident)

launches = build.LaunchCounter()


def kernel_variant(dtype, head_dim: int, group: int, device) -> str:
    """The version that serves a call: ``"plain"`` on the CPU; on a CUDA
    device, with D in :data:`TC_HEAD_DIMS` and G query heads per kv head
    at most one 64-row tile, ``"wgmma"`` for bf16 and ``"tf32x3"`` for
    fp32; else ``"fma"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"packed_prefill_attention: no kernel for device "
                         f"{device}")
    if head_dim in TC_HEAD_DIMS and 1 <= group <= TC_ROWS:
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "fma"


def lanes_per_block(group: int) -> int:
    """Lanes of one tensor-core tile: lanes x G rows fill at most 64 (8
    lanes at G = 8)."""
    return max(1, TC_ROWS // group)


def item_keys(n_pages: int, page_size: int) -> int:
    """Keys of one work item: :data:`KEYS_PER_ITEM`, unless a segment of
    all ``n_pages`` pages would then need more than :data:`MAX_RANGES`
    items; then the fewest whole 64-key tiles that keep it at that many.
    This bounds the partial scratch at MAX_RANGES slots a row."""
    s_max = n_pages * page_size
    if s_max <= KEYS_PER_ITEM * MAX_RANGES:
        return KEYS_PER_ITEM
    tiles = -(-s_max // (64 * MAX_RANGES))
    return 64 * tiles


def work_bounds(c: int, n_segs: int, n_pages: int, page_size: int,
                group: int, n_kv_heads: int) -> dict:
    """Sizes of the tensor-core variants, from the shapes alone: lanes per
    block, lane blocks, keys per item, key ranges a row can have, the most
    work items the planner can emit (every lane block holding
    min(lanes, segments) segments of full length), and the partial
    kernel's grid (enough blocks for every (item, kv head) pair, at most
    :data:`TC_BLOCKS_PER_SM` a SM; the blocks stride over the pairs)."""
    lanes = lanes_per_block(group)
    n_lb = -(-c // lanes)
    keys = item_keys(n_pages, page_size)
    max_ranges = -(-(n_pages * page_size) // keys)
    cap = n_lb * min(lanes, n_segs) * max_ranges
    grid = max(1, min(cap * n_kv_heads, N_SMS * TC_BLOCKS_PER_SM))
    return {"lanes": lanes, "n_lb": n_lb, "item_keys": keys,
            "max_ranges": max_ranges, "item_cap": cap, "grid": grid}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k_pages, v_pages, page_rows, seg_ids, positions, seg_ctx, out;
# C, Hkv, G, D, page_size, n_segs, n_pages; scale; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# ... the same eight, then items, count, acc_part, ml_part; C, Hkv, G, D,
# page_size, n_segs, n_pages, lanes, item_keys, max_ranges, grid; scale;
# stream
_TC_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + \
    [ctypes.c_float, ctypes.c_void_p]
_TC_SYMBOLS = {"wgmma": "packed_prefill_tc_launch",
               "tf32x3": "packed_prefill_tf32x3_launch"}


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
    """Launch the variant of ``csrc/packed_prefill.cu`` that
    :func:`kernel_variant` names, on the current stream."""
    _check(q, k_pages, v_pages, page_rows, seg_ids, positions, seg_ctx)
    c, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    n_segs, n_pages = page_rows.shape
    g = h // hkv
    out = torch.empty_like(q)
    if c == 0:
        return out
    variant = kernel_variant(q.dtype, d, g, q.device)
    ptrs = [t.data_ptr() for t in (q, k_pages, v_pages, page_rows, seg_ids,
                                   positions, seg_ctx, out)]
    if variant in _TC_SYMBOLS:
        if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, out)):
            raise ValueError(f"packed_prefill_attention: the {variant} "
                             f"kernel needs 16-byte-aligned tensors "
                             f"(cp.async)")
        wb = work_bounds(c, n_segs, n_pages, page_size, g, hkv)
        slots = hkv * wb["n_lb"] * wb["max_ranges"] * TC_ROWS
        # scratch: the work items (int4 each) and their count; the fp32
        # partial acc (slots x D) and (m, l) pairs (slots x 2)
        ints = torch.empty((wb["item_cap"] * 4 + 1,), dtype=torch.int32,
                           device=q.device)
        floats = torch.empty((slots * (d + 2),), dtype=torch.float32,
                             device=q.device)
        fn = build.function("packed_prefill", _TC_SYMBOLS[variant],
                            _TC_ARGTYPES)
        args = ptrs + [ints.data_ptr(), ints[wb["item_cap"] * 4:].data_ptr(),
                       floats.data_ptr(), floats[slots * d:].data_ptr()] + [
            c, hkv, g, d, page_size, n_segs, n_pages, wb["lanes"],
            wb["item_keys"], wb["max_ranges"], wb["grid"],
            1.0 / math.sqrt(d)]
    else:
        fn = build.function("packed_prefill", "packed_prefill_launch",
                            _ARGTYPES)
        args = ptrs + [c, hkv, g, d, page_size, n_segs, n_pages,
                       1.0 / math.sqrt(d), _DTYPES[q.dtype]]
    build.check("packed_prefill", build.call_on(q.device, fn, *args))
    launches.add(variant)
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
