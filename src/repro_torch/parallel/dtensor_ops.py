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
* :func:`shard_local`: a dimension that is whole on every rank split
  over given mesh dimensions, each rank keeping its own block (a slice,
  no communication: the SSD's heads after the gathered conv);
* :func:`view_local`: a reshape done shard by shard, the placements kept
  (the head-split SSD output's (B,S,H,P) → (B,S,H·P): torch versions
  plan DTensor's view of a split dimension differently);
* :func:`run_local`: a per-rank body on plain local shards through
  ``local_map``, with the gradient placement of an argument replicated
  beside a split one made ``Partial()`` (:func:`local_rank` gives a
  body its rank over given mesh dimensions): the kernels on DTensors and
  the expert-parallel MoE FFN."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


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


def shard_local(x, dim: int, mesh_dims):
    """DTensor ``x``, replicated on the mesh dimensions ``mesh_dims``,
    split there on dimension ``dim`` (in mesh order, the first the outer
    split); each rank slices its block, and the gradient is gathered back.
    A plain tensor, or no ``mesh_dims``, returns ``x`` as it is."""
    if not isinstance(x, DTensor) or not mesh_dims:
        return x
    dim = dim % x.ndim
    return x.redistribute(x.device_mesh, [
        Shard(dim) if i in mesh_dims else p
        for i, p in enumerate(x.placements)])


def view_local(x, shape):
    """``x.reshape(shape)`` with each rank reshaping its own shard and the
    placements kept: right where every split dimension stays the outer
    factor of the dimension it lands in ((B,S,H,P) split on H → (B,S,H·P)
    split on H·P).  A plain tensor is reshaped."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    mesh = x.device_mesh
    local = list(shape)
    for i, p in enumerate(x.placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(x.to_local().reshape(local), mesh,
                              x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


PARTIAL = "partial"     # an out_dims entry: a partial sum on that dimension


def local_rank(mesh, dims) -> tuple:
    """(rank, ways) of this process over the mesh dimensions ``dims``
    taken together in mesh order, the first the outer split (DTensor's
    order for a tensor dimension that several mesh dimensions shard)."""
    rank, ways = 0, 1
    for i in dims:
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
        ways *= mesh.size(i)
    return rank, ways


def run_local(fn, args, in_dims, out_dims, mesh):
    """``fn(*local args)`` through ``local_map`` on ``mesh``.
    ``in_dims[j]`` lists, per mesh dimension, the dimension of argument
    ``j`` that it shards (None: replicated), or is None for an argument
    that is not a tensor; ``out_dims`` the same for each output, where
    :data:`PARTIAL` marks a partial sum.  Plain tensor arguments enter as
    replicated values.

    A mesh dimension that shards any argument splits the work: an
    argument replicated there (a per-head vector beside a batch-split x,
    GQA's kv head beside split q heads, the tokens beside split experts)
    gets a partial gradient on each shard, so its gradient placement there
    is ``Partial()``, summed when it is redistributed."""

    def place(dims):     # a list: local_map reads a tuple as one per output
        return None if dims is None else [
            Replicate() if d is None else Partial() if d == PARTIAL else
            Shard(d) for d in dims]

    split = [any(d is not None and d[i] is not None for d in in_dims)
             for i in range(mesh.ndim)]

    def grad_place(dims):
        return None if dims is None else [
            Shard(d) if d is not None else
            Partial() if s else Replicate() for d, s in zip(dims, split)]
    args = [a if a is None or isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    outs = tuple(place(d) for d in out_dims)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(place(d) for d in in_dims),
                     in_grad_placements=tuple(grad_place(d) for d in in_dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
