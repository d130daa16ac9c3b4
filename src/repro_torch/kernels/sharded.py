"""Kernels on DTensor inputs: the port's counterpart of ``shard_map``.

The kernels are ``ctypes`` libraries called with ``data_ptr()``, which a
DTensor cannot enter.  Attention and the SSD scan are independent per
batch row and per head, so a wrapper given DTensors runs its kernel
through ``torch.distributed.tensor.experimental.local_map`` on the local
shards, with in-placements that shard at most those dimensions: a mesh
dimension that shards anything else (or holds a partial sum) is
redistributed to ``Replicate()`` before the call, never sent to the plain
version.  The local call goes through the wrapper again, so it launches
the kernel on a CUDA shard (under autograd through the kernel's
``autograd.Function``), and runs the plain version only on a CPU or
``meta`` shard."""

from __future__ import annotations

from typing import Callable, Sequence

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


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


def run_local(fn, args, in_dims, out_dims, mesh):
    """``fn(*local args)`` through ``local_map`` on ``mesh``.
    ``in_dims[j]`` lists, per mesh dimension, the dimension of argument
    ``j`` that it shards (None: replicated), or is None for an argument
    that is not a tensor; ``out_dims`` the same for each output.  Plain
    tensor arguments enter as replicated values.

    The work is split as argument 0 is: an argument replicated on a mesh
    dimension that splits argument 0 (a per-head vector beside a
    batch-split x) gets a partial gradient on each shard, so its gradient
    placement there is ``Partial()``, summed when it is redistributed."""

    def place(dims):     # a list: local_map reads a tuple as one per output
        return None if dims is None else [
            Replicate() if d is None else Shard(d) for d in dims]

    def grad_place(dims):
        return None if dims is None else [
            Shard(d) if d is not None else
            Partial() if split is not None else Replicate()
            for d, split in zip(dims, in_dims[0])]
    args = [a if a is None or isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    outs = tuple(place(d) for d in out_dims)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(place(d) for d in in_dims),
                     in_grad_placements=tuple(grad_place(d) for d in in_dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
