"""DeepSeek-V2's decoder in plain PyTorch and fp32, from the published
equations (DeepSeek-V2 technical report, arXiv:2405.04434, and the
model's ``config.json`` and ``modeling_deepseek.py``), for one device's
share of a layer's experts.

Each layer: RMSNorm (eps from the config), multi-head latent attention in
its expanded form, RMSNorm, then a SwiGLU FFN (the first
``first_k_dense_replace`` layers) or the expert layer.  MLA: q =
q_b(RMSNorm(q_a(x))) split per head into q_nope (``qk_nope_head_dim``)
and q_pe (``qk_rope_head_dim``); the latent c = RMSNorm(kv_a(x)[:rank])
and one shared k_pe = kv_a(x)[rank:]; per head k_nope = c W_uk and v =
c W_uv; q_pe and k_pe roped by YaRN (``rope_scaling``: frequencies
blended between the original and the interpolated by a linear ramp over
the correction range, cos / sin times mscale / mscale_all_dim, the rope
dimensions read as interleaved pairs first, rotate-half form); scores
[q_nope, q_pe] . [k_nope, k_pe] times (nope + rope)^-1/2 mscale_all_dim^2,
causal softmax, then o_proj.  Expert layer: softmax of the router's
logits over all published experts in fp32, group-limited greedy top-k
(the ``topk_group`` groups of ``n_group`` with the best single score),
weights times ``routed_scaling_factor`` (``norm_topk_prob`` false), the
part of the experts held here (``published.first_expert`` onwards, the
config's ``n_routed_experts`` of them) plus the shared experts (one
SwiGLU of ``n_shared_experts`` x ``moe_intermediate_size``).  A final
RMSNorm and an untied head.  No bias anywhere.

Weights arrive as a :class:`Weights` of device tensors in the ``x @ W``
layout, W_uk / W_uv as the two halves of ``kv_b_proj`` per head; each layer
is upcast to fp32 (``quant`` "fp8": first rounded to fp8, the control, as
:mod:`reference.qwen3`) only while it runs.  Matrix products run with
TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from reference.qwen3 import _mm, _up, rms_norm, strict_fp32  # noqa: F401

ATTN_KEYS = ("ln1", "ln2", "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
             "w_uk", "w_uv", "wo")
DENSE_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router", "experts_gate", "experts_up", "experts_down",
            "shared_gate", "shared_up", "shared_down")


@dataclass
class Weights:
    embed: torch.Tensor          # (V, d)
    final_norm: torch.Tensor     # (d,)
    lm_head: torch.Tensor        # (d, V)
    layers: List[Dict[str, torch.Tensor]]   # ATTN_KEYS + DENSE / MOE_KEYS


def layer_keys(layer: Dict[str, torch.Tensor]):
    """The keys of one layer: attention, then its FFN's."""
    return ATTN_KEYS + (MOE_KEYS if "router" in layer else DENSE_KEYS)


def mscale(scale: float, m: float) -> float:
    """``yarn_get_mscale``: 0.1 m ln(scale) + 1, 1 for scale <= 1."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(cfg: dict, device):
    """(inv_freq (rope / 2,), cos / sin magnitude, softmax scale) of the
    config's YaRN rope."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor = rs["factor"]

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] /
                              (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                device=device) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) -
             low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = (1.0 / (factor * pos)) * (1 - mask) + (1.0 / pos) * mask
    mag = mscale(factor, rs["mscale"]) / mscale(factor, rs["mscale_all_dim"])
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5 * \
        mscale(factor, rs["mscale_all_dim"]) ** 2
    return inv, mag, scale


def rope(x, positions, inv, mag):
    """x (S, H, D) roped at ``positions`` (S,): its dimensions read as
    pairs (2i, 2i + 1) and laid out as halves, then rotate-half with cos /
    sin times ``mag``."""
    s, h, d = x.shape
    x = x.reshape(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    ang = positions.float()[:, None] * inv[None, :]
    cos = (torch.cos(ang) * mag)[:, None, :]
    sin = (torch.sin(ang) * mag)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, q_block: int = 512):
    """q, k (S, H, Dqk), v (S, H, Dv) → (S, H, Dv), query blocks of
    ``q_block`` rows."""
    s = q.shape[0]
    kx, vx = k.transpose(0, 1), v.transpose(0, 1)
    out = q.new_empty((s, q.shape[1], v.shape[-1]))
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, q_block):
        b = min(s, a + q_block)
        sc = torch.einsum("qhd,hkd->hqk", q[a:b], kx[:, :b]) * scale
        mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(sc, dim=-1),
                                vx[:, :b])
    return out


def mla(x, w, cfg: dict, positions, quant: Optional[str]):
    """Multi-head latent attention over x (S, d), expanded form."""
    s = x.shape[0]
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rdim, vdim = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    inv, mag, scale = yarn(cfg, x.device)
    q = _mm(rms_norm(_mm(x, w["w_dq"], quant), w["q_norm"], eps),
            w["w_uq"], quant).view(s, h, nope + rdim)
    kv = _mm(x, w["w_dkv"], quant)
    c = rms_norm(kv[:, :rank], w["kv_norm"], eps)
    k_pe = rope(kv[:, None, rank:], positions, inv, mag)
    k_nope = _mm(c, w["w_uk"], quant).view(s, h, nope)
    v = _mm(c, w["w_uv"], quant).view(s, h, vdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, inv, mag)],
                  dim=-1)
    k = torch.cat([k_nope, k_pe.expand(s, h, rdim)], dim=-1)
    return _mm(causal_attention(q, k, v, scale).reshape(s, h * vdim),
               w["wo"], quant)


def swiglu(x, gate, up, down, quant: Optional[str]):
    g = _mm(x, gate, quant)
    return _mm(g * torch.sigmoid(g) * _mm(x, up, quant), down, quant)


def experts(x, w, cfg: dict, quant: Optional[str]):
    """The expert layer's held part plus the shared experts over x (S, d):
    routing over every expert of the router."""
    s = x.shape[0]
    n_group, k = cfg["n_group"], cfg["num_experts_per_tok"]
    scores = torch.softmax(_mm(x, w["router"], quant), dim=-1)
    n_all = scores.shape[-1]
    best = scores.view(s, n_group, -1).amax(dim=-1)
    groups = torch.topk(best, cfg["topk_group"], dim=-1).indices
    keep = torch.zeros_like(best).scatter_(1, groups, 1.0).bool()
    keep = keep[:, :, None].expand(s, n_group, n_all // n_group) \
        .reshape(s, n_all)
    weight, chosen = torch.topk(scores.masked_fill(~keep, 0.0), k, dim=-1)
    weight = weight * cfg["routed_scaling_factor"]
    first = cfg["published"]["first_expert"]
    y = torch.zeros_like(x)
    for j in range(w["experts_gate"].shape[0]):
        tok, slot = torch.nonzero(chosen == first + j, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w["experts_gate"][j], w["experts_up"][j],
                         w["experts_down"][j], quant)
            y.index_add_(0, tok, out * weight[tok, slot, None])
    return y + swiglu(x, w["shared_gate"], w["shared_up"],
                      w["shared_down"], quant)


def block(x, w: Dict[str, torch.Tensor], cfg: dict, positions,
          quant: Optional[str] = None):
    """One decoder layer over x (S, d), fp32."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(rms_norm(x, w["ln1"], eps), w, cfg, positions, quant)
    h = rms_norm(x, w["ln2"], eps)
    if "router" in w:
        return x + experts(h, w, cfg, quant)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], quant)


def logits_at(weights: Weights, cfg: dict, seqs: Sequence[torch.Tensor],
              want: Sequence[torch.Tensor], quant: Optional[str] = None,
              on_layer: Optional[Callable[[int], None]] = None):
    """fp32 logits of each sequence in ``seqs`` (1-D token tensors) at the
    positions ``want`` names: a list of (len(want[i]), V) tensors, layer
    by layer over all sequences, so one layer's fp32 weights live at a
    time."""
    dev = weights.embed.device
    hs = [_up(weights.embed[s.to(dev)], quant, rows_are_channels=True)
          for s in seqs]
    pos = [torch.arange(s.shape[0], device=dev) for s in seqs]
    for i, layer in enumerate(weights.layers):
        # an expert's (E, in, out) weights: channels along dim 2
        w = {k: _up(layer[k], quant, rows_are_channels=layer[k].dim() == 3)
             for k in layer_keys(layer)}
        hs = [block(h, w, cfg, p, quant) for h, p in zip(hs, pos)]
        del w
        if on_layer is not None:
            on_layer(i)
    norm = weights.final_norm.float()
    head = _up(weights.lm_head, quant)
    eps = cfg["rms_norm_eps"]
    return [_mm(rms_norm(h[idx.to(dev)], norm, eps), head, quant)
            for h, idx in zip(hs, want)]
