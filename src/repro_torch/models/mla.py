"""Multi-head Latent Attention (DeepSeek-V2), ported from the JAX
package's ``models/mla.py``.

KV is compressed to a ``kv_lora_rank`` latent plus one shared rope head,
which is all the decode cache stores.  Prefill uses the expanded form,
k = [W_uk·c_kv, k_rope broadcast over heads] and V padded from v_head_dim
to nope + rope, through ``blockwise_attention`` (on the card the flash
kernel at D = nope + rope: 192 at DeepSeek-V2's widths, whose 1 / sqrt(D)
is MLA's softmax scale).  Decode uses the absorbed form: W_uk folded into
the query and W_uv applied after the latent-space attention, fp32 einsums
over the (B, S, rank) and (B, S, rope) caches, updated in place.

A config with ``yarn_factor`` takes DeepSeek-V2's YaRN rope (its
frequencies, its cos / sin magnitude, its softmax scale) and, with
``rope_interleaved``, the published code's de-interleaving of the rope
dimensions before rotate-half (:func:`rope_table`, :func:`rotate`,
:func:`softmax_scale`); the defaults are plain rope at 1 / sqrt(D)."""

from __future__ import annotations

import math

import torch

from .config import options
from .layers import (blockwise_attention, rms_norm, rope_angles,
                     write_rows, yarn_get_mscale, yarn_inv_freq, zero_pad)


def rope_table(cfg, positions):
    """(cos, sin) of the rope head at ``positions`` (...,): two
    (..., rope / 2) fp32 tensors, times YaRN's magnitude
    mscale(factor, yarn_mscale) / mscale(factor, yarn_mscale_all_dim)
    where the config has YaRN."""
    cfg = options(cfg)
    dim = cfg.rope_head_dim
    if not cfg.yarn_factor:
        ang = rope_angles(positions, dim, cfg.rope_theta)
        return torch.cos(ang), torch.sin(ang)
    inv = yarn_inv_freq(dim, cfg.rope_theta, cfg.yarn_factor,
                        cfg.yarn_original_max_position, cfg.yarn_beta_fast,
                        cfg.yarn_beta_slow, positions.device)
    ang = positions[..., None].float() * inv
    m = yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale) / \
        yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def rotate(x, cos, sin, interleaved: bool = False):
    """x (..., H, rope) rotated by the table (cos, sin) (..., rope / 2),
    rotate-half form in fp32, cast back; ``interleaved`` first reads the
    dimensions as pairs (2i, 2i + 1) and lays them out as halves (the
    published DeepSeek-V2 code's ``apply_rotary_pos_emb``)."""
    d = x.shape[-1]
    if interleaved:
        x = x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2) \
            .reshape(x.shape)
    c, s = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softmax_scale(cfg) -> float:
    """MLA's score scale: 1 / sqrt(nope + rope), times
    mscale(factor, yarn_mscale_all_dim) squared under YaRN."""
    cfg = options(cfg)
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= yarn_get_mscale(cfg.yarn_factor,
                                 cfg.yarn_mscale_all_dim) ** 2
    return scale


def _project_q(p, cfg, x, positions):
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q_lat = rms_norm(x @ p.w_dq, p.q_norm)
    q = (q_lat @ p.w_uq).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_table(cfg, positions)
    return q_nope, rotate(q_rope, cos, sin, options(cfg).rope_interleaved)


def _project_kv_latent(p, cfg, x, positions):
    rank = cfg.kv_lora_rank
    lat = x @ p.w_dkv
    c_kv = rms_norm(lat[..., :rank], p.kv_norm)
    cos, sin = rope_table(cfg, positions)
    k_rope = rotate(lat[..., rank:][..., None, :], cos, sin,
                    options(cfg).rope_interleaved)[..., 0, :]
    return c_kv, k_rope


def mla_attention_train(p, cfg, x, positions):
    """Expanded form for prefill: x (B, S, d), positions (1 or B, S) →
    (out (B, S, d), (c_kv (B, S, rank), k_rope (B, S, rope)))."""
    b, s, _ = x.shape
    h, nope, rope, vdim = (cfg.n_heads, cfg.nope_head_dim,
                           cfg.rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_kv, k_rope = _project_kv_latent(p, cfg, x, positions)
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, nope)
    v = (c_kv @ p.w_uv).reshape(b, s, h, vdim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if options(cfg).yarn_factor:
        # the flash kernel scales by 1 / sqrt(nope + rope)
        q = q * (softmax_scale(cfg) * math.sqrt(nope + rope))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rope)],
                  dim=-1)
    # V padded up to the QK head dim, so one kernel serves both products
    v = zero_pad(v, -1, after=nope + rope - vdim)
    out = blockwise_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True)
    out = out[..., :vdim].reshape(b, s, h * vdim)
    return out @ p.wo, (c_kv, k_rope)


def mla_attention_decode(p, cfg, x, cache_ckv, cache_krope, cache_len,
                         positions):
    """Absorbed decode of one token per row: x (B, 1, d); cache_ckv
    (B, S, rank) and cache_krope (B, S, rope), written in place at slot
    ``cache_len - 1``; cache_len (B,) includes the new token.  Returns
    (out (B, 1, d), cache_ckv, cache_krope)."""
    b = x.shape[0]
    h, nope, rope, vdim = (cfg.n_heads, cfg.nope_head_dim,
                           cfg.rope_head_dim, cfg.v_head_dim)
    rank = cfg.kv_lora_rank
    q_nope, q_rope = _project_q(p, cfg, x, positions)       # (B, 1, H, .)
    c_new, kr_new = _project_kv_latent(p, cfg, x, positions)
    pos = cache_len - 1                                      # write slot
    write_rows(cache_ckv, c_new[:, 0], pos)
    write_rows(cache_krope, kr_new[:, 0], pos)

    w_uk = p.w_uk.reshape(rank, h, nope).float()
    # absorb: q' = q_nope · W_uk → (B, H, rank)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk)
    scale = softmax_scale(cfg)
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, cache_ckv.float()) * scale
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          cache_krope.float()) * scale
    scores = s_lat + s_rope
    mask = torch.arange(cache_ckv.shape[1], device=x.device)[None, :] < \
        cache_len.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, :], -1e30)
    pvals = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pvals, cache_ckv.float())
    w_uv = p.w_uv.reshape(rank, h, vdim).float()
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)
    out = out.reshape(b, 1, h * vdim).to(x.dtype)
    return out @ p.wo, cache_ckv, cache_krope
