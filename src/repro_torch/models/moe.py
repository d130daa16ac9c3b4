"""Mixture-of-Experts FFN with capacity-based dispatch, ported from the
JAX package's ``models/moe.py`` literally, so the same tokens are dropped.

Tokens are routed top-k by a router computed in fp32 (a TF32 router would
change which experts win), positions within each expert assigned by a
masked cumsum, then scattered into and gathered from an (E·C, D) buffer:
a kept slot receives exactly one token and a dropped (token, choice) adds
zeros, so the buffer does not depend on the order of the adds.  The expert
SwiGLUs are batched products (``torch.bmm``; the reference leaves its
einsums to XLA, outside any Pallas kernel).  Shared experts (DeepSeek-V2)
are a plain SwiGLU added to the routed output.  The reference's sharding
constraints on the dispatch buffer and the experts' output are kept; on
one device they are no-ops.  On DTensors the routed FFN runs replicated
(:func:`parallel.dtensor_ops.replicated`): the capacity dispatch's
scatter, cumsum and gather over a split token axis have no DTensor rule
that keeps the reference's global token order, so the port does not
split experts (the reference's EP) under a mesh."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..parallel import dtensor_ops
from ..parallel.sharding import constrain


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


def apply_moe_ffn(p, cfg, x):
    """x (B, S, D) → (B, S, D); ``p`` a :class:`MoEFFNParams` (or the same
    leaves as plain attributes)."""
    if dtensor_ops.is_dtensor(x):
        names = p.NAMES + (p.SHARED if p.shared else ())
        return dtensor_ops.replicated(
            lambda xf, **w: apply_moe_ffn(
                SimpleNamespace(shared=p.shared, **w), cfg, xf),
            x, {n: getattr(p, n) for n in names})
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    topw, tope, pos, keep = route(p, cfg, xf)
    slot = (tope * cap + torch.where(keep, pos, torch.zeros_like(pos)))
    slot = slot.reshape(-1)
    contrib = xf[:, None, :] * keep[..., None].to(x.dtype)   # (T, k, D)
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, contrib.reshape(t * k, d))
    buf = constrain(buf.reshape(e, cap, d), "act_experts", None, None)
    h = F.silu(torch.bmm(buf, p.wi_gate)) * torch.bmm(buf, p.wi_up)
    out = constrain(torch.bmm(h, p.wo), "act_experts", None, None)
    out = out.reshape(e * cap, d)
    y = out[slot].reshape(t, k, d)
    y = (y * (topw * keep).to(y.dtype)[..., None]).sum(dim=1)
    if p.shared:
        sh = F.silu(xf @ p.shared_wi_gate) * (xf @ p.shared_wi_up)
        y = y + sh @ p.shared_wo
    return y.reshape(b, s, d)
