"""Zamba2-style hybrid, ported from the JAX package's ``models/hybrid.py``:
a Mamba2 backbone plus ONE shared attention block whose weights are reused
at every application site (every ``shared_attn_every`` layers).  Each site
keeps its own KV cache (same weights, different activations).

The shared block's full-sequence attention runs through the flash kernel
(:func:`repro_torch.models.layers.blockwise_attention`), its Mamba2 blocks'
SSD through the SSD kernel.  The decode cache is ``{"ssm", "conv"}`` as
for Mamba2 plus ``{"attn_k", "attn_v"}`` of shape (sites, B, S, Hkv, D),
all updated in place."""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.sharding import constrain
from .layers import (
    apply_rope,
    blockwise_attention,
    decode_attention,
    embed,
    lm_loss,
    remat,
    rms_norm,
    rope_angles,
    update_kv_cache,
)
from .params import (DTYPES, Zamba2Params, abstract_params,
                     init_zamba2_params, resolve_device, token_inputs)
from .ssm import (SSM_CACHE_SPECS, init_ssm_cache, mamba_block_decode,
                  mamba_block_train)
from .transformer import _qkv, ffn_apply


class Zamba2LM:
    def __init__(self, cfg):
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba2LM needs a 'hybrid' config, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        every = cfg.shared_attn_every
        # site i covers layers [i * every, min((i + 1) * every, L))
        self.groups = [(off, min(every, cfg.n_layers - off))
                       for off in range(0, cfg.n_layers, every)]
        self.n_sites = len(self.groups)

    def init(self, seed: int = 0, device=None) -> Zamba2Params:
        """Seeded weights on ``device`` (``None`` = the card)."""
        return init_zamba2_params(self.cfg, seed, device)

    def abstract_params(self):
        """``(params, specs)``: the parameters on ``meta`` and their logical
        axes (:func:`repro_torch.models.params.abstract_params`)."""
        return abstract_params(self.cfg)

    # -------------------------------------------------------- shared attn
    def _shared_train(self, p, x, angles):
        b, s, _ = x.shape
        q, k, v = _qkv(p.attn, self.cfg, rms_norm(x, p.ln1))
        q, k = apply_rope(q, angles), apply_rope(k, angles)
        out = blockwise_attention(q, k, v, causal=True)
        x = x + out.reshape(b, s, -1) @ p.attn.wo
        return x + ffn_apply(p.ffn, rms_norm(x, p.ln2))

    def _shared_decode(self, p, x, k_cache, v_cache, cache_len, angles):
        q, k, v = _qkv(p.attn, self.cfg, rms_norm(x, p.ln1))
        q, k = apply_rope(q, angles), apply_rope(k, angles)
        update_kv_cache(k_cache, v_cache, k, v, cache_len - 1)
        out = decode_attention(q[:, 0], k_cache, v_cache, cache_len)
        x = x + out.reshape(x.shape[0], 1, -1) @ p.attn.wo
        return x + ffn_apply(p.ffn, rms_norm(x, p.ln2))

    # -------------------------------------------------------------- train
    def logits_fn(self, params: Zamba2Params, batch):
        """Full-sequence forward → (logits (B,S,V), labels); under grad
        the shared block at every site and each Mamba2 block are
        rematerialised (:func:`layers.remat`), as the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = constrain(embed(params.embed, tokens), "batch", "seq",
                      "act_embed")
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        shared = remat(self._shared_train, cfg)
        block = remat(mamba_block_train, cfg)
        for off, size in self.groups:
            x = shared(params.shared, x, angles)
            for blk in params.blocks[off:off + size]:
                x = block(blk, cfg, x)
        x = rms_norm(x, params.final_norm)
        return constrain(x @ params.lm_head, "batch", "seq", "act_vocab"), \
            tokens

    def loss_fn(self, params: Zamba2Params, batch):
        """Mean next-token cross-entropy over ``batch`` (fp32 scalar)."""
        return lm_loss(*self.logits_fn(params, batch))

    # ------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zeroed cache: the Mamba2 state plus one (B, max_len, Hkv, D)
        K and V per attention site."""
        cfg = self.cfg
        cache = init_ssm_cache(cfg, batch_size, device)
        shape = (self.n_sites, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        dev = resolve_device(device)
        cache["attn_k"] = torch.zeros(shape, dtype=DTYPES[cfg.dtype],
                                      device=dev)
        cache["attn_v"] = torch.zeros(shape, dtype=DTYPES[cfg.dtype],
                                      device=dev)
        return cache

    def cache_specs(self) -> Dict[str, tuple]:
        """The logical axes of each :meth:`init_cache` entry."""
        kv = ("layers", "batch", "decode_seq", "act_kv_heads", "head_dim")
        return dict(SSM_CACHE_SPECS, attn_k=kv, attn_v=kv)

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins of every model input (the dry run)."""
        return token_inputs(shape)[0]

    def input_axes(self, shape) -> Dict[str, tuple]:
        return token_inputs(shape)[1]

    def decode_step(self, params: Zamba2Params, cache, batch):
        """One token for every sequence.  batch: tokens (B,1), cache_len
        (B,) including the new token.  Returns (logits (B,V), cache); the
        cache is updated in place."""
        cfg = self.cfg
        cache_len = batch["cache_len"]
        x = constrain(embed(params.embed, batch["tokens"]),    # (B,1,d)
                      "batch", None, "act_embed")
        angles = rope_angles((cache_len - 1)[:, None], cfg.head_dim,
                             cfg.rope_theta)
        for site, (off, size) in enumerate(self.groups):
            x = self._shared_decode(params.shared, x, cache["attn_k"][site],
                                    cache["attn_v"][site], cache_len, angles)
            for i in range(off, off + size):
                x = mamba_block_decode(params.blocks[i], cfg, x,
                                       cache["ssm"][i], cache["conv"][i])
        x = rms_norm(x, params.final_norm)
        return constrain(x[:, 0] @ params.lm_head, "batch", "act_vocab"), \
            cache
