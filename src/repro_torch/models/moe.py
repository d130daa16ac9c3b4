"""Mixture-of-Experts FFN with capacity-based dispatch, ported from the
JAX package's ``models/moe.py`` literally, so the same tokens are dropped.

Tokens are routed top-k by a router computed in fp32 (a TF32 router would
change which experts win), positions within each expert assigned by a
masked cumsum, then scattered into and gathered from an (E·C, D) buffer:
a kept slot receives exactly one token and a dropped (token, choice) adds
zeros, so the buffer does not depend on the order of the adds.  The expert
SwiGLUs are batched products (``torch.bmm``; the reference leaves its
einsums to XLA, outside any Pallas kernel).  Shared experts (DeepSeek-V2)
are a plain SwiGLU added to the routed output.

Under a mesh the experts are split as the reference's rule table splits
them (``"experts"`` → ``model``, or ``(data, model)`` under ``ep_wide``):
each rank runs :func:`expert_partial` for its own experts on its tokens
(:func:`_moe_sharded`), with no buffer rows for experts it does not hold,
and the routed output is a partial sum over the expert split."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from ..parallel.dtensor_ops import PARTIAL, is_dtensor, local_rank, \
    run_local


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens, in Python floats as the
    reference takes it (decode at B = 4 with 64 experts top-8 gets 1)."""
    return max(int(n_tokens * cfg.top_k * cfg.capacity_factor /
                   cfg.n_experts), 1)


def route(p, cfg, xf):
    """Top-k routing of xf (T, D) → (topw (T, k) fp32 renormalised, tope
    (T, k) expert ids, pos (T, k) each choice's position in its expert,
    keep (T, k) bool: the position is inside the capacity)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(xf.float() @ p.router.float(), dim=-1)
    topw, tope = torch.topk(gates, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(tope, e).reshape(t * k, e)
    pos = ((torch.cumsum(flat, dim=0) * flat).sum(-1) - 1).reshape(t, k)
    keep = (pos < capacity(cfg, t)) & (pos >= 0)
    return topw, tope, pos, keep


def expert_counts(tope, n_experts: int):
    """(E,) int: how many of the choices ``tope`` (T, k) each expert
    receives; a token block's offsets are the sums of the blocks before
    it."""
    return F.one_hot(tope, n_experts).sum((0, 1))


def expert_partial(p, cfg, xf, routing, *, cap: int, first: int = 0):
    """One rank's routed experts on its tokens: xf (T, D); ``routing`` the
    (topw, tope, pos) of :func:`route` on xf, pos counted over the whole
    batch (plus each expert's choices in the token blocks before this
    one); ``p.wi_gate`` / ``p.wi_up`` (E_l, D, F) and ``p.wo`` (E_l, F,
    D) the experts ``first .. first + E_l - 1``; ``cap`` the capacity of
    the whole batch.  Returns (y (T, D), the gated sum over the choices
    routed to these experts and kept; keep (T, k), which choices the
    capacity keeps, over every expert).  Summed over the expert blocks it
    is the routed FFN; a choice outside the block or over capacity adds
    zeros to row 0 of the block's (E_l·cap, D) buffer."""
    t, d = xf.shape
    e_l = p.wi_gate.shape[0]
    topw, tope, pos = routing
    keep = (pos < cap) & (pos >= 0)
    local = tope - first
    mine = keep & (local >= 0) & (local < e_l)
    slot = torch.where(mine, local * cap + pos, torch.zeros_like(pos)) \
        .reshape(-1)
    contrib = xf[:, None, :] * mine[..., None].to(xf.dtype)   # (T, k, D)
    buf = torch.zeros((e_l * cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, contrib.reshape(-1, d))
    buf = buf.reshape(e_l, cap, d)
    h = F.silu(torch.bmm(buf, p.wi_gate)) * torch.bmm(buf, p.wi_up)
    out = torch.bmm(h, p.wo).reshape(e_l * cap, d)
    y = out[slot].reshape(t, -1, d)
    y = (y * (topw * mine).to(y.dtype)[..., None]).sum(dim=1)
    return y, keep


def _shared(p, x):
    sh = F.silu(x @ p.shared_wi_gate) * (x @ p.shared_wi_up)
    return sh @ p.shared_wo


def apply_moe_ffn(p, cfg, x):
    """x (B, S, D) → (B, S, D); ``p`` a :class:`MoEFFNParams` (or the same
    leaves as plain attributes).  DTensors run expert-parallel
    (:func:`_moe_sharded`)."""
    if is_dtensor(x):
        y = _moe_sharded(p, cfg, x)
    else:
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        y, _ = expert_partial(p, cfg, xf, route(p, cfg, xf)[:3],
                              cap=capacity(cfg, b * s))
        y = y.reshape(b, s, d)
    return y + _shared(p, x) if p.shared else y


def _moe_sharded(p, cfg, x):
    """The routed FFN of DTensor x (B, S, D) with the experts split as
    ``wi_gate`` is (the reference's EP): each rank runs
    :func:`expert_partial` on its experts, never gathered (their
    embedding dimension is, as FSDP's), and the router is gathered.

    Tokens: a mesh dimension that splits the batch but not the experts
    keeps its token block, whose offsets (each expert's choices in the
    blocks before it, in the global batch-major order, the first mesh
    dimension the outer split) come from an all-gather of one (E,) count
    a block; a mesh dimension that splits the experts gathers the tokens.
    So the same (token, choice) pairs are kept as on one device.  The
    output is a partial sum over the expert split, then placed as x is
    (a reduce-scatter or an all-reduce)."""
    mesh = x.device_mesh
    b, s, d = x.shape
    cap = capacity(cfg, b * s)
    experts = [0 if q.is_shard(0) else None for q in p.wi_gate.placements]
    tokens = [0 if q.is_shard(0) and e is None else None
              for q, e in zip(x.placements, experts)]
    block, _ = local_rank(
        mesh, [i for i, e in enumerate(experts) if e is not None])
    token_dims = [i for i, t in enumerate(tokens) if t is not None]
    rank, _ = local_rank(mesh, token_dims)

    def body(xl, router, wi_gate, wi_up, wo):
        xf = xl.reshape(-1, d)
        w = SimpleNamespace(router=router, wi_gate=wi_gate, wi_up=wi_up,
                            wo=wo)
        topw, tope, pos, _ = route(w, cfg, xf)
        if token_dims:
            counts = expert_counts(tope, cfg.n_experts)[None]
            for i in reversed(token_dims):     # the inner split first
                counts = funcol.all_gather_tensor(counts, 0, (mesh, i))
            pos = pos + counts[:rank].sum(0)[tope]
        y, _ = expert_partial(w, cfg, xf, (topw, tope, pos), cap=cap,
                              first=block * wi_gate.shape[0])
        return y.reshape(xl.shape)
    out = [t if e is None else PARTIAL for t, e in zip(tokens, experts)]
    y = run_local(
        body, (x, p.router, p.wi_gate, p.wi_up, p.wo),
        (tokens, [None] * mesh.ndim, experts, experts, experts), (out,),
        mesh)
    return y.redistribute(mesh, x.placements)
