"""Multi-head latent attention over a paged latent pool: the hand-written
Hopper kernels, their wrappers and their plain PyTorch versions.

Replaces no TPU kernel: the JAX package decodes MLA with plain einsums over
a contiguous latent cache (``repro/models/mla.py``), and has no paged one.
The serving engine keeps one pool row a token a layer, the RMS-normed
latent (``kv_lora_rank`` = 512 values) then the roped key dimensions (64):
1,152 bytes in bf16 against 4,096 for Qwen3-32B's K and V.  The kernels
are in ``csrc/mla_attention.cu``:

* :func:`mla_attention` — absorbed-form attention: each row's query
  (B, H, 576), q_nope already multiplied through W_uk, scores against its
  pool rows through the block table, softmax in fp32, output (B, H, 512)
  in latent space (the caller applies W_uv).  One block of sixteen warps
  per (64 heads, row, split), both products on the tensor cores
  (``mma.sync``), split-K partials merged by a combine kernel where a
  batch does not fill the card.  A decode call and a prefill chunk's lanes
  (one row per lane, context = position + 1) run the same body under
  distinct entry names (``mla_decode_*`` / ``mla_prefill_*``).
* :func:`mla_latent_store` — a lane's latent RMSNorm and its key rope,
  written straight into its pool row at (``wr_page``, ``wr_slot``); a
  negative page writes nothing.

Bound on H100: near the ridge.  A decode row of ~1,150 keys reads 1.3 MB
of latent and does 128 x 1,088 x 2 operations a key (239 a byte); the
store is bytes and one launch.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs the plain version.  There is no fallback.  The attention
kernel takes bf16 with 64 x n heads, a 512-wide latent and 64 rope
dimensions; the store float32 and bf16.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

N_SMS = 132          # H100 SXM
LATENT = 512         # the kernel's latent width
ROPE = 64            # the kernel's rope dimensions
HEADS = 64           # query heads a block
STEP_KEYS = 32       # keys a step of the kernel
MAX_SPLITS = 16
MIN_SPLIT_KEYS = 256  # a shorter split costs more in its partial than it saves

# launches by kind: "decode", "prefill", "latent_store"
launches = build.LaunchCounter()

# q, pool, block_tables, context_lens, occupancy, out, acc, m, l; B, H,
# page_size, n_pages, num_splits, keys_per_split; scale; prefill; stream
_ATTN_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# kv, gain, cos, sin, pool, wr_page, wr_slot; rows, page_size; eps;
# interleaved, dtype; stream
_STORE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def default_num_splits(batch: int, n_heads: int, max_keys: int) -> int:
    """Splits for 132 SMs: enough (head block, row, split) blocks for about
    two per SM, at least :data:`MIN_SPLIT_KEYS` keys a split, at most
    :data:`MAX_SPLITS`."""
    blocks = max(1, batch * max(1, n_heads // HEADS))
    want = -(-2 * N_SMS // blocks)
    return max(1, min(want, max_keys // MIN_SPLIT_KEYS, MAX_SPLITS))


def mla_splits(batch: int, n_heads: int, max_keys: int, device):
    """The split count a call of ``batch`` rows over at most ``max_keys``
    keys runs on ``device``, to pass on as ``num_splits`` where another
    call must sum its rows in the same order; None on the CPU."""
    if torch.device(device).type == "cpu":
        return None
    return default_num_splits(batch, n_heads, max_keys)


# ------------------------------------------------------------- attention


def mla_attention_plain(q, pool, block_tables, context_lens, occupancy,
                        scale: float, rank: int):
    """The kernel's function in plain PyTorch, fp32 inside: q (B, H,
    rank + rope), pool (P, page, rank + rope) → (B, H, rank) in q's dtype;
    rows with occupancy 0 or no key are 0."""
    b, _, dim = q.shape
    page = pool.shape[1]
    live = (context_lens > 0) & occupancy
    n_keys = int(context_lens.max()) if b else 0
    n_pages = -(-n_keys // page)
    keys = pool[block_tables[:, :n_pages].long()].reshape(
        b, n_pages * page, dim).float()
    s = torch.einsum("bhd,bsd->bhs", q.float(), keys) * scale
    mask = torch.arange(n_pages * page, device=q.device)[None, :] < \
        context_lens[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bsr->bhr", p, keys[..., :rank])
    return torch.where(live[:, None, None], out, 0.0).to(q.dtype)


def _check_attention(q, pool, block_tables, context_lens, occupancy):
    b, h, dim = q.shape if q.dim() == 3 else (0, 0, 0)
    if q.dim() != 3 or q.dtype != torch.bfloat16 or h % HEADS or \
            dim != LATENT + ROPE:
        raise ValueError(f"mla_attention: the kernel takes q (B, 64 n, "
                         f"{LATENT + ROPE}) bf16, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if pool.dim() != 3 or pool.dtype != q.dtype or pool.shape[2] != dim:
        raise ValueError(f"mla_attention: pool (P, page, {dim}) {q.dtype}, "
                         f"got {tuple(pool.shape)} {pool.dtype}")
    if block_tables.dtype != torch.int32 or \
            context_lens.dtype != torch.int32 or \
            occupancy.dtype != torch.bool:
        raise TypeError("mla_attention: block_tables and context_lens "
                        "int32, occupancy bool")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            context_lens.shape != (b,) or occupancy.shape != (b,):
        raise ValueError("mla_attention: block_tables (B, n_pages), "
                         "context_lens (B,) and occupancy (B,) must match q")
    tensors = (q, pool, block_tables, context_lens, occupancy)
    if any(t.device != q.device for t in tensors):
        raise ValueError("mla_attention: all tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mla_attention: all tensors must be contiguous")
    if q.data_ptr() % 16 or pool.data_ptr() % 16:
        raise ValueError("mla_attention: q and pool 16-byte aligned "
                         "(cp.async)")


def mla_attention_cuda(q, pool, block_tables, context_lens, occupancy,
                       scale: float, num_splits=None, prefill=False):
    """Launch ``mla_attention_launch`` of ``csrc/mla_attention.cu`` on the
    current stream."""
    _check_attention(q, pool, block_tables, context_lens, occupancy)
    b, h, _ = q.shape
    page = pool.shape[1]
    n_pages = block_tables.shape[1]
    max_keys = n_pages * page
    if num_splits is None:
        num_splits = default_num_splits(b, h, max_keys)
    if not 1 <= num_splits <= MAX_SPLITS:
        raise ValueError(f"mla_attention: num_splits in [1, {MAX_SPLITS}], "
                         f"got {num_splits}")
    per = -(-max_keys // num_splits)
    per = -(-per // STEP_KEYS) * STEP_KEYS
    out = torch.empty((b, h, LATENT), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    acc = m = l_ = 0
    if num_splits > 1:
        rows = num_splits * b * h
        scratch = torch.empty((rows * (LATENT + 2),), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        m = acc + 4 * rows * LATENT
        l_ = m + 4 * rows
    fn = build.function("mla_attention", "mla_attention_launch",
                        _ATTN_ARGTYPES)
    build.check("mla_attention", build.call_on(
        q.device, fn, q.data_ptr(), pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(),
        occupancy.data_ptr(), out.data_ptr(), acc, m, l_, b, h, page,
        n_pages, num_splits, per, scale, int(prefill)))
    launches.add("prefill" if prefill else "decode")
    return out


def mla_attention(q, pool, block_tables, context_lens, *, scale: float,
                  rank: int = LATENT, occupancy=None, num_splits=None,
                  prefill: bool = False):
    """q (B, H, rank + rope), the absorbed queries; pool (P, page,
    rank + rope) one layer's latent rows; block_tables (B, n_pages) int32;
    context_lens (B,) int32; occupancy (B,) bool optional (False rows are
    padding: output 0) → (B, H, rank), ``rank`` the latent width (the
    kernel's is :data:`LATENT`).  ``prefill`` launches the prefill
    entry names (a chunk's lanes as rows); ``num_splits`` as
    :func:`mla_splits`.  CUDA tensors launch the kernel, CPU tensors run
    :func:`mla_attention_plain` (no splits)."""
    if occupancy is None:
        occupancy = torch.ones(q.shape[0], dtype=torch.bool,
                               device=q.device)
    if q.is_cuda:
        if rank != LATENT:
            raise ValueError(f"mla_attention: the kernel's latent is "
                             f"{LATENT} wide, got {rank}")
        return mla_attention_cuda(q, pool, block_tables, context_lens,
                                  occupancy, scale, num_splits, prefill)
    if q.device.type != "cpu":
        raise ValueError(f"mla_attention: no kernel for device {q.device}")
    return mla_attention_plain(q, pool, block_tables, context_lens,
                               occupancy, scale, rank)


# ----------------------------------------------------------- latent store


def mla_latent_store_plain(kv, gain, cos, sin, pool, wr_page, wr_slot,
                           interleaved: bool, eps: float):
    """The lanes' latent RMSNorm and key rope (``models/layers.py``
    ``rms_norm``, ``models/mla.py`` ``rotate``) stored at their rows whose
    page is not negative."""
    from ..models.layers import rms_norm   # models import kernels.ops
    from ..models.mla import rotate
    rank = gain.shape[0]
    c_kv = rms_norm(kv[:, :rank], gain, eps)
    k_rope = rotate(kv[:, None, rank:], cos, sin, interleaved)[:, 0]
    live = wr_page >= 0
    pool[wr_page[live], wr_slot[live]] = torch.cat([c_kv, k_rope],
                                                   dim=-1)[live]


def mla_latent_store_cuda(kv, gain, cos, sin, pool, wr_page, wr_slot,
                          interleaved: bool, eps: float):
    """Launch ``mla_latent_store_launch`` of ``csrc/mla_attention.cu`` on
    the current stream."""
    rows = kv.shape[0]
    if kv.dtype not in _DTYPES or gain.dtype != kv.dtype or \
            pool.dtype != kv.dtype:
        raise TypeError("mla_latent_store: kv, gain and pool share float32 "
                        "or bfloat16")
    if kv.shape[1:] != (LATENT + ROPE,) or gain.shape != (LATENT,) or \
            pool.shape[2:] != (LATENT + ROPE,) or \
            cos.shape != (rows, ROPE // 2) or sin.shape != cos.shape or \
            wr_page.shape != (rows,) or wr_slot.shape != (rows,):
        raise ValueError(f"mla_latent_store: kv {tuple(kv.shape)}, pool "
                         f"{tuple(pool.shape)}, cos {tuple(cos.shape)}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 or \
            wr_page.dtype != torch.int64 or wr_slot.dtype != torch.int64:
        raise TypeError("mla_latent_store: cos / sin float32, wr_page / "
                        "wr_slot int64")
    tensors = (kv, gain, cos, sin, pool, wr_page, wr_slot)
    if not all(t.is_contiguous() and t.device == kv.device
               for t in tensors):
        raise ValueError("mla_latent_store: contiguous tensors on one "
                         "device")
    fn = build.function("mla_attention", "mla_latent_store_launch",
                        _STORE_ARGTYPES)
    build.check("mla_attention", build.call_on(
        kv.device, fn, *(t.data_ptr() for t in tensors), rows,
        pool.shape[1], eps, int(interleaved), _DTYPES[kv.dtype]))
    launches.add("latent_store")


def mla_latent_store(kv, gain, cos, sin, pool, wr_page, wr_slot, *,
                     interleaved: bool = False, eps: float = 1e-6):
    """kv (N, rank + rope) the lanes' latent projections, gain (rank,) the
    latent norm's, cos / sin (N, rope / 2) fp32 the lanes' rope table;
    stores ``[rms_norm(kv[:, :rank]) * gain, rope(kv[:, rank:])]`` at
    ``pool[wr_page, wr_slot]`` (pool (P, page, rank + rope), in place) for
    every lane whose page is not negative.  CUDA tensors launch the
    kernel, CPU tensors run :func:`mla_latent_store_plain`."""
    if kv.is_cuda:
        return mla_latent_store_cuda(kv, gain, cos, sin, pool, wr_page,
                                     wr_slot, interleaved, eps)
    if kv.device.type != "cpu":
        raise ValueError(f"mla_latent_store: no kernel for device "
                         f"{kv.device}")
    return mla_latent_store_plain(kv, gain, cos, sin, pool, wr_page,
                                  wr_slot, interleaved, eps)
