"""GPipe-style pipeline parallelism, ported from the JAX package's
``parallel/pipeline.py``.

The layer stack is split into ``n_stages`` contiguous stages, one per
rank of a ``torch.distributed`` group, and microbatches stream through
them: each tick every stage runs its layers on what it holds and sends
the result to the next stage (``batch_isend_irecv``, the reference's
``ppermute``).  Schedule: GPipe fill-drain, ``M + S - 1`` ticks for ``M``
microbatches over ``S`` stages, bubble fraction (S-1)/(M+S-1).  The loop
is written by hand rather than taken from ``torch.distributed.pipelining``
so that it is the reference's schedule tick for tick.  The last stage's
outputs reach every rank by ``all_reduce`` (the reference's ``psum``:
every other stage holds zeros)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist


def split_stages(stacked_params: Dict[str, torch.Tensor], n_stages: int):
    """Split stacked (L, ...) parameters into (S, L/S, ...): the leading
    stage axis is what the ranks divide among themselves."""
    def rs(p):
        n = p.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return p.reshape(n_stages, n // n_stages, *p.shape[1:])
    return {k: rs(v) for k, v in stacked_params.items()}


def gpipe_forward(block_fn: Callable, group=None, *, n_microbatches: int):
    """Returns ``fn(stage_params, x)`` running a GPipe forward on this rank.

    ``block_fn(layer_params, h) -> h`` is the per-layer body;
    ``stage_params`` leaves are (S, L/S, ...) (see :func:`split_stages`;
    this rank runs stage ``rank``) and ``x`` is (M, mb, ...) — the
    microbatched activations, the same on every rank.  Returns the
    (M, mb, ...) outputs of the last stage, on every rank."""
    def stage_body(params, h):
        for i in range(next(iter(params.values())).shape[0]):
            h = block_fn({k: v[i] for k, v in params.items()}, h)
        return h

    def pipelined(stage_params, x):
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages) \
            if group is not None else (stage + 1) % n_stages
        prv = dist.get_global_rank(group, (stage - 1) % n_stages) \
            if group is not None else (stage - 1) % n_stages
        params = {k: v[stage] for k, v in stage_params.items()}
        m = x.shape[0]
        if m != n_microbatches:
            raise ValueError(f"x has {m} microbatches, want {n_microbatches}")
        buf = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        for t in range(m + n_stages - 1):
            # stage 0 ingests microbatch t while there is one; the others
            # take what the previous stage sent last tick
            h_in = x[t] if stage == 0 and t < m else buf
            h_out = stage_body(params, h_in)
            if n_stages > 1:
                buf = torch.empty_like(h_out)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)])
                for r in reqs:
                    r.wait()
            else:
                buf = h_out
            # the last stage emits microbatch t - (S - 1) once it is full
            if stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = h_out
        dist.all_reduce(outputs, group=group)
        return outputs

    return pipelined
