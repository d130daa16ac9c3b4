"""Shared neural primitives for the dense decoder, ported from the JAX
package's ``models/layers.py``.  Norms and rotary embeddings compute in
fp32 inside and cast back, as the reference does."""

from __future__ import annotations

import math

import torch

# ----------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- rotary


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions (...,) int → (..., head_dim//2) fp32 angles."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv_freq


def apply_rope(x, angles):
    """x (..., S, H, D); angles (..., S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]   # add the head axis
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention


def causal_attention(q, k, v):
    """Full causal attention, q (B,S,H,D), k/v (B,S,Hkv,D) → (B,S,H,D),
    fp32 softmax (the plain counterpart of the reference's blockwise
    streaming softmax; same function)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.reshape(b, s, hkv, g, d).float() * (1.0 / math.sqrt(d))
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode attention against a (B, S, Hkv, D) cache.

    ``cache_len`` (B,) int — valid prefix length per sequence, including
    the new token (whose K/V must already be written)."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[1]  # q: (B, H, D)
    g = h // hkv
    qg = q.reshape(b, hkv, g, d).float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    mask = torch.arange(s, device=q.device)[None, :] < \
        cache_len.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write one new token's K/V at per-sequence position ``pos`` (B,), in
    place (the reference returns updated copies)."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, pos.long()] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos.long()] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
