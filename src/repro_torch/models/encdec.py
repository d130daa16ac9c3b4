"""Whisper-style encoder-decoder, ported from the JAX package's
``models/encdec.py``.

The conv audio frontend is a stub there too: the encoder takes
precomputed frame embeddings (B, enc_seq, d_model).  Positions are
sinusoidal in both stacks (the reference's deviation from Whisper's
learned decoder positions).  Blocks are pre-LN with LayerNorm (fp32
inside, population variance), attention has as many kv heads as heads,
and the FFN is a tanh-GELU MLP with biases.

Every full-sequence attention goes through the flash kernel
(``layers.blockwise_attention``): the encoder's self-attention
(non-causal, Sq = Sk = enc_seq), the decoder's causal self-attention and
its cross-attention from T queries to the enc_seq memory keys
(non-causal, Sq != Sk).  The decode step runs the plain
``decode_attention`` for self and cross, as the reference does (it has no
kernel there).

The decode cache is ``{"k", "v"}`` (dec_layers, B, max_len, H, D) and
``{"cross_k", "cross_v"}`` (dec_layers, B, enc_seq, H, D), updated in
place.  As in the reference, nothing here fills the cross entries: the
caller writes each decoder layer's ``memory @ cross.wk`` / ``wv`` there."""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.sharding import constrain
from .layers import (
    blockwise_attention,
    decode_attention,
    embed,
    gelu_mlp,
    layer_norm,
    lm_loss,
    remat,
    sinusoidal_positions,
    update_kv_cache,
)
from .params import (DTYPES, WhisperParams, abstract_params,
                     init_whisper_params, meta, resolve_device,
                     token_inputs)


def _mha(p, cfg, xq, xkv, causal: bool):
    """Multi-head attention of xq (B,Sq,d) over xkv (B,Sk,d) through the
    flash kernel; ``p`` an AttentionParams."""
    b, s, _ = xq.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (xq @ p.wq).reshape(b, s, h, hd)
    k = (xkv @ p.wk).reshape(b, xkv.shape[1], h, hd)
    v = (xkv @ p.wv).reshape(b, xkv.shape[1], h, hd)
    out = blockwise_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p.wo


def _ffn(p, x):
    return gelu_mlp(x, p.wi, p.bi, p.wo, p.bo)


def _encoder_block(blk, cfg, x):
    a = layer_norm(x, blk.ln1_s, blk.ln1_b)
    x = x + _mha(blk.attn, cfg, a, a, causal=False)
    return x + _ffn(blk.ffn, layer_norm(x, blk.ln2_s, blk.ln2_b))


def _decoder_block(blk, cfg, x, memory):
    a = layer_norm(x, blk.ln1_s, blk.ln1_b)
    x = x + _mha(blk.attn, cfg, a, a, causal=True)
    a = layer_norm(x, blk.ln3_s, blk.ln3_b)
    x = x + _mha(blk.cross, cfg, a, memory, causal=False)
    return x + _ffn(blk.ffn, layer_norm(x, blk.ln2_s, blk.ln2_b))


class WhisperEncDec:
    """Whisper backbone: ``logits_fn`` encodes ``frames`` and decodes
    ``tokens`` in one pass; ``decode_step`` feeds one token per sequence
    against the self cache and the caller's cross cache."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    def init(self, seed: int = 0, device=None) -> WhisperParams:
        """Seeded weights on ``device`` (``None`` = the card)."""
        return init_whisper_params(self.cfg, seed, device)

    def abstract_params(self):
        """``(params, specs)``: the parameters on ``meta`` and their logical
        axes (:func:`repro_torch.models.params.abstract_params`)."""
        return abstract_params(self.cfg)

    # -------------------------------------------------------------- paths
    def _encode(self, params: WhisperParams, frames):
        """frames (B, enc_seq, d) → the memory (B, enc_seq, d): sinusoidal
        positions, pre-LN blocks with non-causal self-attention, the
        final LayerNorm."""
        cfg = self.cfg
        x = frames.to(self.dtype) + sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(self.dtype)
        x = constrain(x, "batch", "seq", "act_embed")
        block = remat(_encoder_block, cfg)
        for blk in params.enc_blocks:
            x = block(blk, cfg, x)
        return layer_norm(x, params.enc_norm_s, params.enc_norm_b)

    def logits_fn(self, params: WhisperParams, batch):
        """batch: frames (B, enc_seq, d), tokens (B, T) → (logits
        (B, T, V), tokens).  Under grad each encoder and decoder block is
        rematerialised (:func:`layers.remat`)."""
        cfg = self.cfg
        memory = self._encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = embed(params.embed, tokens)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
        x = constrain(x, "batch", "seq", "act_embed")
        block = remat(_decoder_block, cfg)
        for blk in params.dec_blocks:
            x = block(blk, cfg, x, memory)
        x = layer_norm(x, params.dec_norm_s, params.dec_norm_b)
        return constrain(x @ params.lm_head, "batch", "seq", "act_vocab"), \
            tokens

    def loss_fn(self, params: WhisperParams, batch):
        """Mean next-token cross-entropy over ``batch`` (fp32 scalar)."""
        return lm_loss(*self.logits_fn(params, batch))

    # ------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zeroed cache: k / v (dec_layers, B, max_len, H, D) and cross_k /
        cross_v (dec_layers, B, enc_seq, H, D)."""
        cfg = self.cfg
        dev = resolve_device(device)
        heads = (cfg.n_heads, cfg.head_dim)
        shapes = {"k": max_len, "v": max_len, "cross_k": cfg.enc_seq,
                  "cross_v": cfg.enc_seq}
        return {name: torch.zeros((cfg.dec_layers, batch_size, s) + heads,
                                  dtype=self.dtype, device=dev)
                for name, s in shapes.items()}

    def cache_specs(self) -> Dict[str, tuple]:
        """The logical axes of each :meth:`init_cache` entry."""
        kv = ("layers", "batch", "decode_seq", "act_kv_heads", "head_dim")
        cross = ("layers", "batch", None, "act_kv_heads", "head_dim")
        return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins of every model input (the dry run): frames
        (B, enc_seq, d) beside the tokens to train or prefill."""
        out = token_inputs(shape)[0]
        if shape.kind in ("train", "prefill"):
            out = {"frames": meta((shape.global_batch, self.cfg.enc_seq,
                                   self.cfg.d_model), self.dtype), **out}
        return out

    def input_axes(self, shape) -> Dict[str, tuple]:
        out = token_inputs(shape)[1]
        if shape.kind in ("train", "prefill"):
            out = {"frames": ("batch", "seq", None), **out}
        return out

    def decode_step(self, params: WhisperParams, cache, batch):
        """One token for every sequence.  batch: tokens (B,1), cache_len
        (B,) including the new token.  Returns (logits (B,V), cache); the
        self cache is updated in place, the cross cache only read."""
        cfg = self.cfg
        cache_len = batch["cache_len"]
        b = batch["tokens"].shape[0]
        h, hd = cfg.n_heads, cfg.head_dim
        x = embed(params.embed, batch["tokens"])             # (B,1,d)
        # the sinusoidal position of the new token, in fp32
        pos = (cache_len - 1).float()[:, None]
        i = torch.arange(cfg.d_model // 2, dtype=torch.float32,
                         device=x.device)[None, :]
        ang = pos / (10000.0 ** (2 * i / cfg.d_model))
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)],
                          dim=-1)[:, None, :].to(x.dtype)
        full = torch.full((b,), cache["cross_k"].shape[2],
                          dtype=cache_len.dtype, device=x.device)
        for i, blk in enumerate(params.dec_blocks):
            a = layer_norm(x, blk.ln1_s, blk.ln1_b)
            q = (a @ blk.attn.wq).reshape(b, 1, h, hd)
            k = (a @ blk.attn.wk).reshape(b, 1, h, hd)
            v = (a @ blk.attn.wv).reshape(b, 1, h, hd)
            kc, vc = cache["k"][i], cache["v"][i]
            update_kv_cache(kc, vc, k, v, cache_len - 1)
            out = decode_attention(q[:, 0], kc, vc, cache_len)
            x = x + out.reshape(b, 1, -1) @ blk.attn.wo
            a = layer_norm(x, blk.ln3_s, blk.ln3_b)
            q = (a @ blk.cross.wq).reshape(b, 1, h, hd)
            out = decode_attention(q[:, 0], cache["cross_k"][i],
                                   cache["cross_v"][i], full)
            x = x + out.reshape(b, 1, -1) @ blk.cross.wo
            x = x + _ffn(blk.ffn, layer_norm(x, blk.ln2_s, blk.ln2_b))
        x = layer_norm(x, params.dec_norm_s, params.dec_norm_b)
        return constrain(x[:, 0] @ params.lm_head, "batch", "act_vocab"), \
            cache
