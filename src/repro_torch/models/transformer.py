"""Decoder-only LM of the ``dense``, ``moe`` and ``vlm`` families (dense
llama-style blocks, routed MoE FFNs, MLA attention, a
``first_dense_layers`` prefix, and Qwen2-VL's M-RoPE text backbone fed
projected patch embeddings), ported from the JAX package's
``models/transformer.py``.

The model object holds the config and the functions; the weights are a
:class:`~repro_torch.models.params.DecoderParams` passed to each call, as
the reference passes its parameter tree.  Each layer has a kind,
``dense | moe | mla_dense | mla_moe`` (:func:`layer_kinds`): the head
blocks (the first ``first_dense_layers``) theirs, the tail one kind.  The
contiguous decode cache is ``{"k", "v"}`` of shape (L, B, S, Hkv, D), or
for MLA ``{"c_kv", "k_rope"}`` of shapes (L, B, S, rank) and
(L, B, S, rope), L the tail's layers, plus ``head_``-prefixed entries for
the head blocks; it is updated in place."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, split_dim
from .layers import (
    apply_rope,
    blockwise_attention,
    decode_attention,
    embed,
    lm_loss,
    mrope_angles,
    remat,
    rms_norm,
    rope_angles,
    update_kv_cache,
)
from .mla import mla_attention_decode, mla_attention_train
from .moe import apply_moe_ffn
from .params import (DTYPES, DecoderParams, abstract_params, init_params,
                     layer_kinds, meta, resolve_device, token_inputs)


def _qkv(p, cfg, x):
    """p: one block's AttentionParams; x (B,S,d) → q (B,S,H,D),
    k/v (B,S,Hkv,D)."""
    q = split_dim(x @ p.wq, -1, cfg.n_heads, cfg.head_dim)
    k = split_dim(x @ p.wk, -1, cfg.n_kv_heads, cfg.head_dim)
    v = split_dim(x @ p.wv, -1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return q, k, v


def ffn_apply(p, x, cfg=None, kind: str = "dense"):
    """The block's FFN: SwiGLU (``p`` an FFNParams), or for a ``moe``
    kind the routed experts (``p`` a MoEFFNParams; needs ``cfg``)."""
    if kind.endswith("moe"):
        return apply_moe_ffn(p, cfg, x)
    h = F.silu(x @ p.wi_gate) * (x @ p.wi_up)
    return constrain(h, "batch", "seq", "act_mlp") @ p.wo


def attention_train(p, cfg, x, angles):
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    q = constrain(q, "batch", "seq", "act_heads", None)
    out = blockwise_attention(q, k, v, causal=True)
    return out.reshape(b, s, -1) @ p.wo


def block_train(p, cfg, x, angles, kind: str):
    """One block over the full sequence; ``angles`` are rope angles, or
    for MLA the positions (MLA applies its own decoupled rope)."""
    h = rms_norm(x, p.ln1)
    if kind.startswith("mla"):
        attn_out, _ = mla_attention_train(p.attn, cfg, h, angles)
    else:
        attn_out = attention_train(p.attn, cfg, h, angles)
    x = x + attn_out
    x = x + ffn_apply(p.ffn, rms_norm(x, p.ln2), cfg, kind)
    return constrain(x, "batch", "seq", "act_embed")


def block_decode(p, cfg, x, cache, i, prefix, cache_len, angles, kind):
    """One block for one token per row, reading and writing layer ``i`` of
    the cache entries named with ``prefix`` ("" or "head_")."""
    h = rms_norm(x, p.ln1)
    if kind.startswith("mla"):
        out, _, _ = mla_attention_decode(
            p.attn, cfg, h, cache[prefix + "c_kv"][i],
            cache[prefix + "k_rope"][i], cache_len, angles)
    else:
        k_cache, v_cache = cache[prefix + "k"][i], cache[prefix + "v"][i]
        q, k, v = _qkv(p.attn, cfg, h)
        q, k = apply_rope(q, angles), apply_rope(k, angles)
        update_kv_cache(k_cache, v_cache, k, v, cache_len - 1)
        out = decode_attention(q[:, 0], k_cache, v_cache, cache_len)
        out = out.reshape(x.shape[0], 1, -1) @ p.attn.wo
    x = x + out
    return x + ffn_apply(p.ffn, rms_norm(x, p.ln2), cfg, kind)


class DecoderLM:
    """Dense / MoE / MLA / VLM decoder LM (llama-style: RMSNorm, RoPE or
    M-RoPE, GQA, SwiGLU; routed experts; latent attention).

    The ``vlm`` family (Qwen2-VL) takes ``patch_embeds`` (B, S_vis,
    vision_embed_dim), the vision frontend's output (a stub in the
    reference too), and ``positions_thw`` (B, S_vis + S_text, 3) in its
    ``logits_fn`` batch; the projected patches come BEFORE the text and
    get label -1.  Its ``decode_step`` takes ``positions_thw`` (B, 1, 3)
    beside ``cache_len``."""

    def __init__(self, cfg):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM builds the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.kinds = layer_kinds(cfg)
        self.n_head = cfg.first_dense_layers
        self.n_tail = cfg.n_layers - self.n_head

    def init(self, seed: int = 0, device=None) -> DecoderParams:
        """Seeded weights on ``device`` (``None`` = the card)."""
        return init_params(self.cfg, seed, device)

    def abstract_params(self):
        """``(params, specs)``: the parameters on ``meta`` and their logical
        axes (:func:`repro_torch.models.params.abstract_params`)."""
        return abstract_params(self.cfg)

    def _layers(self, params):
        """(block params, kind, cache prefix, cache index) in order."""
        return [(blk, self.kinds[i], "head_", i)
                for i, blk in enumerate(params.head_blocks)] + \
            [(blk, self.kinds[-1], "", i)
             for i, blk in enumerate(params.blocks)]

    def _angles(self, positions, batch):
        """Rotary angles at ``positions``; a ``vlm`` model reads
        ``batch["positions_thw"]`` instead (M-RoPE)."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return mrope_angles(batch["positions_thw"], cfg.head_dim,
                                cfg.mrope_sections, cfg.rope_theta)
        if cfg.use_mla:
            return positions         # MLA applies its own decoupled rope
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def _embed_inputs(self, params, batch):
        """→ (x (B,S,d), angles, labels (B,S)): a ``vlm`` batch's
        projected patches lead the text, labelled -1."""
        tokens = batch["tokens"]
        x = embed(params.embed, tokens)
        labels = tokens
        if self.cfg.family == "vlm":
            vis = batch["patch_embeds"].to(x.dtype) @ params.vision_proj
            x = torch.cat([vis, x], dim=1)
            labels = torch.cat([torch.full(
                (tokens.shape[0], vis.shape[1]), -1, dtype=tokens.dtype,
                device=tokens.device), tokens], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return constrain(x, "batch", "seq", "act_embed"), \
            self._angles(positions, batch), labels

    # ------------------------------------------------------------- train
    def logits_fn(self, params: DecoderParams, batch):
        """Full-sequence forward → (logits (B,S,V), labels).  Under grad
        each tail block is rematerialised (:func:`layers.remat`), as the
        reference checkpoints its scanned body; the head blocks are not."""
        x, angles, labels = self._embed_inputs(params, batch)
        tail = remat(block_train, self.cfg)
        for blk, kind, prefix, _ in self._layers(params):
            x = (tail if prefix == "" else block_train)(
                blk, self.cfg, x, angles, kind)
        x = rms_norm(x, params.final_norm)
        return constrain(x @ params.lm_head, "batch", "seq", "act_vocab"), \
            labels

    def loss_fn(self, params: DecoderParams, batch):
        """Mean next-token cross-entropy over ``batch`` (fp32 scalar)."""
        return lm_loss(*self.logits_fn(params, batch))

    # ------------------------------------------------------------ decode
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zeroed contiguous cache: {"k", "v"} (L, B, S, Hkv, D) each, or
        for MLA {"c_kv", "k_rope"} (L, B, S, rank / rope); L counts the
        tail, and the head blocks get the same entries prefixed
        ``head_``."""
        cfg = self.cfg
        if cfg.use_mla:
            widths = {"c_kv": (cfg.kv_lora_rank,),
                      "k_rope": (cfg.rope_head_dim,)}
        else:
            widths = {"k": (cfg.n_kv_heads, cfg.head_dim),
                      "v": (cfg.n_kv_heads, cfg.head_dim)}
        dev = resolve_device(device)
        cache = {}
        for prefix, n in (("", self.n_tail), ("head_", self.n_head)):
            if n:
                for name, w in widths.items():
                    cache[prefix + name] = torch.zeros(
                        (n, batch_size, max_len) + w, dtype=self.dtype,
                        device=dev)
        return cache

    def cache_specs(self) -> Dict[str, tuple]:
        """The logical axes of each :meth:`init_cache` entry."""
        if self.cfg.use_mla:
            axes = {"c_kv": ("layers", "batch", "decode_seq", "kv_lora"),
                    "k_rope": ("layers", "batch", "decode_seq", None)}
        else:
            kv = ("layers", "batch", "decode_seq", "act_kv_heads",
                  "head_dim")
            axes = {"k": kv, "v": kv}
        out = dict(axes)
        if self.n_head:
            out.update({"head_" + k: v for k, v in axes.items()})
        return out

    # --------------------------------------------------------------- I/O
    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins of every model input for a ``ShapeSpec``
        (the dry run)."""
        cfg = self.cfg
        if cfg.family != "vlm":
            return token_inputs(shape)[0]
        b, s = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            s_vis = int(s * cfg.vision_frac)
            return {"tokens": meta((b, s - s_vis)),
                    "patch_embeds": meta((b, s_vis, cfg.vision_embed_dim),
                                         self.dtype),
                    "positions_thw": meta((b, s, 3))}
        return {"tokens": meta((b, 1)), "cache_len": meta((b,)),
                "positions_thw": meta((b, 1, 3))}

    def input_axes(self, shape) -> Dict[str, tuple]:
        """The logical axes of each :meth:`input_specs` entry."""
        if self.cfg.family != "vlm":
            return token_inputs(shape)[1]
        if shape.kind in ("train", "prefill"):
            return {"tokens": ("batch", "seq"),
                    "patch_embeds": ("batch", "seq", None),
                    "positions_thw": ("batch", "seq", None)}
        return {"tokens": ("batch", None), "cache_len": ("batch",),
                "positions_thw": ("batch", None, None)}

    def decode_step(self, params: DecoderParams, cache, batch):
        """One token for every sequence.  batch: tokens (B,1), cache_len
        (B,) including the new token (and for ``vlm`` positions_thw
        (B,1,3)).  Returns (logits (B,V), cache); the cache is updated in
        place."""
        cache_len = batch["cache_len"]
        x = constrain(embed(params.embed, batch["tokens"]),    # (B,1,d)
                      "batch", None, "act_embed")
        angles = self._angles((cache_len - 1)[:, None], batch)
        for blk, kind, prefix, i in self._layers(params):
            x = block_decode(blk, self.cfg, x, cache, i, prefix, cache_len,
                             angles, kind)
        x = rms_norm(x, params.final_norm)
        return constrain(x[:, 0] @ params.lm_head, "batch", "act_vocab"), \
            cache
