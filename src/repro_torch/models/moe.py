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
and the routed output is a partial sum over the expert split.

:func:`dropless_moe` is the serving engine's expert layer, beside the
capacity path: no (token, choice) is ever dropped, so a row's output does
not depend on its batch.  It routes over all ``n_experts`` by the config's
rule (:func:`route_dropless`: softmax scores in fp32, plain or
group-limited greedy top-k, renormalised or scaled) and computes the part
that the experts this device holds (``first_expert`` ..  ``first_expert
+ experts_held - 1``) give: on the card as three grouped products over
the (token, choice) pairs permuted by expert, with static shapes and no
host sync; on the CPU as a plain loop over the held experts."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.dtensor_ops import PARTIAL, is_dtensor, local_rank, \
    run_local
from .config import options


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


def route_dropless(router, cfg, xf):
    """Routing of xf (T, D) over all ``cfg.n_experts`` experts → (weights
    (T, k) fp32, experts (T, k)): softmax of the fp32 router logits; with
    ``topk_method`` "group_limited_greedy" only the ``topk_group`` of
    ``n_group`` consecutive expert groups with the best single score
    compete (DeepSeek-V2's ``MoEGate``); the chosen weights are
    renormalised when ``norm_topk_prob`` (and k > 1), else multiplied by
    ``routed_scaling_factor``."""
    cfg = options(cfg)
    t = xf.shape[0]
    scores = torch.softmax(xf.float() @ router.float(), dim=-1)
    if cfg.topk_method == "group_limited_greedy":
        groups = scores.view(t, cfg.n_group, -1).amax(dim=-1)
        keep = torch.zeros_like(groups).scatter_(
            1, torch.topk(groups, cfg.topk_group, dim=-1).indices, 1.0)
        keep = keep.bool()[:, :, None].expand(
            t, cfg.n_group, cfg.n_experts // cfg.n_group).reshape(t, -1)
        scores = scores.masked_fill(~keep, 0.0)
    elif cfg.topk_method != "greedy":
        raise ValueError(f"unknown topk_method {cfg.topk_method!r}")
    topw, tope = torch.topk(scores, cfg.top_k, dim=-1)
    if cfg.top_k > 1 and cfg.norm_topk_prob:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        topw = topw * cfg.routed_scaling_factor
    return topw, tope


def _held_plain(p, xf, topw, local, held):
    """The held experts' part on the CPU: one SwiGLU per expert over the
    pairs routed to it, weighted and summed per token in fp32."""
    y = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for j in range(p.wi_gate.shape[0]):
        tok, choice = torch.nonzero(held & (local == j), as_tuple=True)
        if tok.numel() == 0:
            continue
        h = xf[tok]
        a = F.silu(h @ p.wi_gate[j]) * (h @ p.wi_up[j])
        out = (a @ p.wo[j]).float() * topw[tok, choice, None]
        y.index_add_(0, tok, out)
    return y


def _held_grouped(p, xf, topw, local, held):
    """The held experts' part on the card: the (token, choice) pairs
    sorted by held expert (the rest last) into a (T k, D) buffer, three
    grouped products over the per-expert row offsets (``torch._grouped_mm``;
    rows past the last offset are never read back), SiLU * mul through the
    fused kernel, then each pair's row gathered back to its (token,
    choice) and the weighted pairs summed per token in fp32.  Every shape
    is static and nothing waits for the device."""
    t, k = local.shape
    e_l = p.wi_gate.shape[0]
    key = torch.where(held, local, e_l).reshape(-1)
    order = torch.argsort(key, stable=True)
    # each held expert's end row: searchsorted, as bincount would wait for
    # the device to size its output
    offs = torch.searchsorted(key[order], torch.arange(
        e_l, device=key.device), right=True).to(torch.int32)
    xs = xf[order // k]
    a = ops.silu_mul(torch._grouped_mm(xs, p.wi_gate, offs=offs),
                     torch._grouped_mm(xs, p.wi_up, offs=offs))
    ys = torch._grouped_mm(a, p.wo, offs=offs)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    yp = ys[back].view(t, k, -1).float()
    yp = torch.where(held[..., None], yp * topw[..., None], 0.0)
    return yp.sum(dim=1)


def dropless_moe(p, cfg, xf, live=None, pairs=None):
    """The dropless expert layer on xf (T, D): the routed part that the
    held experts (``p.wi_gate`` / ``p.wi_up`` (E_l, D, F), ``p.wo`` (E_l,
    F, D), experts ``cfg.first_expert`` ..) give, plus the shared experts
    once.  ``live`` (T,) bool marks real rows (padding rows route nowhere);
    ``pairs``, a device int64 scalar, is incremented by the number of
    (token, choice) pairs routed to held experts (no sync).  Returns (T, D)
    in xf's dtype."""
    topw, tope = route_dropless(p.router, cfg, xf)
    local = tope - options(cfg).first_expert
    held = (local >= 0) & (local < p.wi_gate.shape[0])
    if live is not None:
        held = held & live[:, None]
    if pairs is not None:
        pairs += held.sum()
    fn = _held_grouped if xf.is_cuda else _held_plain
    y = fn(p, xf, topw, local, held).to(xf.dtype)
    if not p.shared:
        return y
    return y + ops.silu_mul(xf @ p.shared_wi_gate, xf @ p.shared_wi_up) @ \
        p.shared_wo
