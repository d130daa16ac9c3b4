"""Shared neural primitives of the models, ported from the JAX package's
``models/layers.py``.  Norms and rotary embeddings compute in
fp32 inside and cast back, as the reference does."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel import dtensor_ops
from ..parallel.dtensor_ops import is_dtensor, unshard
from ..parallel.sharding import constrain, split_dim

# ----------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32 inside with the population variance (the
    reference's ``jnp.var``), cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ------------------------------------------------------------- embedding


def embed(table, tokens):
    """Rows of ``table`` (V, d) at ``tokens`` (the reference's
    ``jnp.take``).  A DTensor table is gathered over the vocabulary
    first: DTensor's rules for a lookup in a vocabulary shard fail on
    torch 2.11 (the index's backward) and 2.13 (batch-split tokens)."""
    return F.embedding(tokens.long(), unshard(table, 0))


def zero_pad(x, dim: int, before: int = 0, after: int = 0):
    """``x`` with ``before`` / ``after`` zeros along ``dim``, by
    concatenation (torch 2.11's DTensor rule for ``F.pad`` returns one
    placement on a 2-D mesh)."""
    dim %= x.ndim

    def zeros(n):
        shape = x.shape[:dim] + (n,) + x.shape[dim + 1:]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([zeros(before), x, zeros(after)], dim=dim)


# ----------------------------------------------------------------- rotary


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions (...,) int → (..., head_dim//2) fp32 angles."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv_freq


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention-magnitude factor 0.1 m ln(s) + 1 (1 for s <= 1):
    DeepSeek-V2's ``yarn_get_mscale``."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(beta_fast: float, beta_slow: float, dim: int,
                          theta: float, original_max_position: int):
    """The rotary pairs (low, high) between which YaRN blends the
    interpolated and the original frequencies: the pairs that turn
    ``beta_fast`` and ``beta_slow`` times over the original context,
    floored and ceiled, clipped to [0, dim - 1]."""
    def pair(rotations):
        return dim * math.log(original_max_position /
                              (rotations * 2 * math.pi)) / \
            (2 * math.log(theta))
    return max(math.floor(pair(beta_fast)), 0), \
        min(math.ceil(pair(beta_slow)), dim - 1)


def yarn_inv_freq(dim: int, theta: float, factor: float,
                  original_max_position: int, beta_fast: float,
                  beta_slow: float, device=None):
    """(dim // 2,) fp32 YaRN frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): each pair's original frequency
    (extrapolation) below the correction range, the frequency divided by
    ``factor`` (interpolation) above it, and a linear ramp between."""
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    low, high = yarn_correction_range(beta_fast, beta_slow, dim, theta,
                                      original_max_position)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) -
             low) / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    return (1.0 / (factor * base)) * (1 - extra) + (1.0 / base) * extra


def mrope_angles(positions_thw, head_dim: int, sections,
                 theta: float = 1000000.0):
    """Qwen2-VL M-RoPE: positions (..., S, 3) as [t, h, w] → (..., S,
    head_dim//2) fp32 angles; frequency slot j takes its position from
    the axis of the section it lies in (``sections`` sum to
    head_dim//2)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {half}")
    dev = positions_thw.device
    exps = torch.arange(0, half, dtype=torch.float32, device=dev) / half
    inv_freq = 1.0 / (theta ** exps)
    section_ids = torch.cat([torch.full((n,), axis, dtype=torch.long,
                                        device=dev)
                             for axis, n in enumerate(sections)])
    pos = positions_thw.float()
    pos_sel = torch.gather(
        pos, -1, section_ids.expand(pos.shape[:-1] + (half,)))
    return pos_sel * inv_freq


def sinusoidal_positions(seq_len: int, dim: int, device=None):
    """(seq_len, dim) fp32 ``[sin | cos]`` halves side by side (not
    interleaved), frequency ``10000 ** (-2 i / dim)``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def apply_rope(x, angles):
    """x (..., S, H, D); angles (..., S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]   # add the head axis
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention


def blockwise_attention(q, k, v, *, causal: bool):
    """Full-sequence attention, q (B,S,H,D), k/v (B,S,Hkv,D) → (B,S,H,D),
    fp32 online softmax: the reference's ``blockwise_attention`` (the
    pure-JAX mirror of its flash kernel), run through the flash kernel
    (:func:`repro_torch.kernels.ops.flash_attention`; on a CPU tensor its
    plain version).  The reference's KV ``chunk`` only orders the sums, so
    it is not an argument here."""
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode attention against a (B, S, Hkv, D) cache.

    ``cache_len`` (B,) int — valid prefix length per sequence, including
    the new token (whose K/V must already be written)."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[1]  # q: (B, H, D)
    g = h // hkv
    qg = split_dim(q, 1, hkv, g).float() * (1.0 / math.sqrt(d))
    mask = torch.arange(s, device=q.device)[None, :] < \
        cache_len.long()[:, None]
    if is_dtensor(k_cache):
        return dtensor_ops.decode_attention(qg, k_cache, v_cache, mask) \
            .reshape(b, 1, h, d).to(q.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def write_rows(cache, new, pos):
    """``cache[b, pos[b]] = new[b]`` for every row ``b`` of a (B, S, ...)
    cache, in place (a DTensor cache, its sequence sharded as
    ``decode_seq`` is, by :func:`dtensor_ops.write_rows`)."""
    new = new.to(cache.dtype)
    if is_dtensor(cache):
        return dtensor_ops.write_rows(cache, new, pos)
    cache[torch.arange(cache.shape[0], device=cache.device),
          pos.long()] = new
    return cache


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write one new token's K/V at per-sequence position ``pos`` (B,), in
    place (the reference returns updated copies); see
    :func:`write_rows`."""
    write_rows(k_cache, k_new[:, 0], pos)
    write_rows(v_cache, v_new[:, 0], pos)
    return k_cache, v_cache


# ------------------------------------------------------------------ MLP


def gelu_mlp(x, wi, bi, wo, bo):
    """GELU MLP with biases.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so this is ``approximate="tanh"`` (torch's default, the
    erf form, differs by up to ~1e-3)."""
    h = F.gelu(x @ wi + bi, approximate="tanh")
    return constrain(h, "batch", "seq", "act_mlp") @ wo + bo


# ----------------------------------------------------------- loss / head


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Stable CE in fp32 (logsumexp minus the gold logit), positions
    labelled ``ignore_id`` masked out; returns (mean_loss, token_count),
    the count clamped to at least 1."""
    logits = logits.float()
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        gold = dtensor_ops.gold_logit(logits, safe)
    else:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    count = mask.sum().clamp(min=1)
    return nll.sum() / count, count


def lm_loss(logits, labels):
    """Next-token loss: each position's label is the next one's (the
    reference's ``roll(labels, -1)``), the last position's is -1."""
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                        dim=1)
    return cross_entropy_loss(logits, shifted)[0]


def remat(fn, cfg):
    """``fn`` under activation checkpointing (``cfg.remat == "full"``, the
    reference's ``jax.checkpoint`` of each block) when grad mode is on:
    its activations are dropped after the forward and recomputed, by
    running ``fn`` again, in the backward.  Otherwise ``fn`` itself."""
    if cfg.remat != "full" or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)
