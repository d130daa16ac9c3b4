"""The DTensor forms of model operations, in one place.

A model runs the same code on plain tensors and, under a mesh, on
DTensors.  Where DTensor has no sharding rule for an operation as the
model writes it, or its rule fails or takes minutes to plan, the model
calls the form here on a DTensor and keeps its own form on a plain
tensor, where this one would cost more:

* :func:`unshard`: a dimension gathered before a slice whose bounds are
  not shard bounds (the identity on a plain tensor);
* :func:`write_rows`: one row per batch row written by an elementwise
  select, which every shard applies to its own rows without moving the
  cache (DTensor has no in-place scatter into a sharded dimension);
* :func:`decode_attention`: one query token's attention by broadcast
  products and sums, which keep the cache's sequence split (planning the
  einsums' contractions over a 3-D mesh takes minutes);
* :func:`gold_logit`: the gold logit by a mask (DTensor's gather along a
  split class dimension yields a partial value it cannot reduce at rank
  3);
* :func:`replicated`: a function run on full tensors on every rank, the
  result placed as its input was (the MoE capacity dispatch: no DTensor
  rule keeps its global token order through scatter, cumsum and
  gather)."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def unshard(x, dim: int):
    """``x`` with dimension ``dim`` whole on every rank: a DTensor split
    there is gathered (other splits kept); a plain tensor is returned as
    it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    if not any(p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements])


def write_rows(cache, new, pos):
    """``cache[b, pos[b]] = new[b]`` on a DTensor (B, S, ...) cache, in
    place; ``new`` already in the cache's dtype."""
    at = torch.arange(cache.shape[1], device=pos.device)[None, :] == \
        pos.long()[:, None]
    at = at.reshape(at.shape + (1,) * (cache.ndim - 2))
    cache.copy_(torch.where(at, new[:, None], cache))
    return cache


def decode_attention(qg, k_cache, v_cache, mask):
    """fp32 attention of ``qg`` (B, Hkv, G, D), already scaled, against a
    DTensor (B, S, Hkv, D) cache, ``mask`` (B, S) the visible keys →
    (B, Hkv, G, D)."""
    scores = (qg[:, None] * k_cache.float()[:, :, :, None, :]).sum(-1)
    scores = scores.masked_fill(~mask[:, :, None, None], -1e30)  # (B,S,K,G)
    p = torch.softmax(scores, dim=1)
    return (p[..., None] * v_cache.float()[:, :, :, None, :]).sum(1)


def gold_logit(logits, labels):
    """``logits[..., labels]`` of DTensor ``logits``: one value plus
    zeros, the gather's value."""
    hit = torch.arange(logits.shape[-1], device=labels.device) == \
        labels[..., None]
    return torch.where(hit, logits, 0.0).sum(dim=-1)


def replicated(fn, x, tensors):
    """``fn(x, **tensors)`` on full tensors on every rank (each DTensor
    gathered, and its gradient flowing back to its placement), the
    result placed as DTensor ``x`` is (a partial placement replicated)."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def full(t):
        return t.redistribute(mesh, rep).to_local() \
            if isinstance(t, DTensor) else t
    y = fn(full(x), **{k: full(t) for k, t in tensors.items()})
    return DTensor.from_local(y, mesh, rep, run_check=False).redistribute(
        mesh, [Replicate() if q.is_partial() else q for q in x.placements])
