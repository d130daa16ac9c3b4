"""Kernels on DTensor inputs: the port's counterpart of ``shard_map``.

The kernels are ``ctypes`` libraries called with ``data_ptr()``, which a
DTensor cannot enter.  Attention and the SSD scan are independent per
batch row and per head, so a wrapper given DTensors runs its kernel
through ``parallel.dtensor_ops.run_local`` (``local_map``) on the local
shards, with in-placements that shard at most those dimensions
(:func:`split_dims`): a mesh dimension that shards anything else (or
holds a partial sum) is redistributed to ``Replicate()`` before the call,
never sent to the plain version.  The local call goes through the wrapper
again, so it launches the kernel on a CUDA shard (under autograd through
the kernel's ``autograd.Function``), and runs the plain version only on a
CPU or ``meta`` shard.

Each per-rank body is a plain function on plain tensors (:func:`gqa_local`,
``ssd_scan`` on a block of heads), so a test or the chip smoke can run it
rank by rank on one device."""

from __future__ import annotations

from typing import Callable, Sequence


def split_dims(t, allowed: Sequence[int], sizes_ok: Callable[[int, int],
                                                              bool]):
    """For each mesh dimension of DTensor ``t``: the tensor dimension it
    shards if that is one of ``allowed`` and ``sizes_ok(dim, product of
    the mesh sizes sharding dim)`` holds, else None (replicate)."""
    mesh = t.device_mesh
    total = {}
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim in allowed:
            total[p.dim] = total.get(p.dim, 1) * mesh.size(i)
    return [p.dim if p.is_shard() and p.dim in allowed and
            sizes_ok(p.dim, total[p.dim]) else None for p in t.placements]


def gqa_local(q, k, v, rank: int, ways: int, causal: bool):
    """One rank's attention when its ``ways``-way head split leaves each
    rank fewer q heads than a kv group holds: q (B,S,H/ways,D) is rank
    ``rank``'s block of heads, k / v (B,S,Hkv,D) hold every kv head, and
    the block's one kv head, ``(rank * H/ways) // (H/Hkv)``, is attended
    through the flash kernel at H/ways q heads and 1 kv head."""
    from .flash_attention import flash_attention
    hl = q.shape[2]
    group = hl * ways // k.shape[2]
    if group % hl:
        raise ValueError(f"gqa_local: {hl} q heads a rank straddle kv "
                         f"groups of {group}")
    j = rank * hl // group
    return flash_attention(q.contiguous(), k[:, :, j:j + 1].contiguous(),
                           v[:, :, j:j + 1].contiguous(), causal=causal)
