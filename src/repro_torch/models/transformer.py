"""Dense decoder-only LM, ported from the JAX package's
``models/transformer.py`` (the ``dense`` family only; moe, mla and vlm are
not ported yet).

The model object holds the config and the functions; the weights are a
:class:`~repro_torch.models.params.DecoderParams` passed to each call, as
the reference passes its parameter tree.  The contiguous decode cache is
``{"k", "v"}`` of shape (L, B, S, Hkv, D), updated in place."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import (
    apply_rope,
    causal_attention,
    decode_attention,
    rms_norm,
    rope_angles,
    update_kv_cache,
)
from .params import DTYPES, DecoderParams, init_params, resolve_device


def _qkv(p, cfg, x):
    """p: one block's AttentionParams; x (B,S,d) → q (B,S,H,D),
    k/v (B,S,Hkv,D)."""
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return q, k, v


def ffn_apply(p, x):
    """SwiGLU: p one block's FFNParams."""
    return (F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo


class DecoderLM:
    """Dense decoder LM (llama-style: RMSNorm, RoPE, GQA, SwiGLU)."""

    def __init__(self, cfg):
        if cfg.family != "dense" or cfg.use_mla or cfg.n_experts or \
                cfg.first_dense_layers:
            raise NotImplementedError(
                f"the torch port serves the dense family only; "
                f"{cfg.name!r} (family {cfg.family!r}) waits for ROADMAP "
                f"A.10 (other model families)")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    def init(self, seed: int = 0, device=None) -> DecoderParams:
        """Seeded weights on ``device`` (``None`` = the card)."""
        return init_params(self.cfg, seed, device)

    # ------------------------------------------------------------- train
    def logits_fn(self, params: DecoderParams, batch):
        """Full-sequence forward → (logits (B,S,V), labels)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params.embed[tokens.long()]
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        for blk in params.blocks:
            h = rms_norm(x, blk.ln1)
            q, k, v = _qkv(blk.attn, cfg, h)
            q, k = apply_rope(q, angles), apply_rope(k, angles)
            out = causal_attention(q, k, v)
            x = x + out.reshape(x.shape[0], x.shape[1], -1) @ blk.attn.wo
            x = x + ffn_apply(blk.ffn, rms_norm(x, blk.ln2))
        x = rms_norm(x, params.final_norm)
        return x @ params.lm_head, tokens

    # ------------------------------------------------------------ decode
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zeroed contiguous cache {"k", "v"}: (L, B, S, Hkv, D) each."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def decode_step(self, params: DecoderParams, cache, batch):
        """One token for every sequence.  batch: tokens (B,1), cache_len
        (B,) including the new token.  Returns (logits (B,V), cache); the
        cache is updated in place."""
        cfg = self.cfg
        cache_len = batch["cache_len"]
        x = params.embed[batch["tokens"].long()]               # (B,1,d)
        angles = rope_angles((cache_len - 1)[:, None], cfg.head_dim,
                             cfg.rope_theta)
        for i, blk in enumerate(params.blocks):
            h = rms_norm(x, blk.ln1)
            q, k, v = _qkv(blk.attn, cfg, h)
            q, k = apply_rope(q, angles), apply_rope(k, angles)
            update_kv_cache(cache["k"][i], cache["v"][i], k, v, cache_len - 1)
            out = decode_attention(q[:, 0], cache["k"][i], cache["v"][i],
                                   cache_len)
            x = x + out.reshape(x.shape[0], 1, -1) @ blk.attn.wo
            x = x + ffn_apply(blk.ffn, rms_norm(x, blk.ln2))
        x = rms_norm(x, params.final_norm)
        return x[:, 0] @ params.lm_head, cache
