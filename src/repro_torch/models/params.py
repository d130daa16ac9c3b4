"""Parameters of the dense decoder: ``nn.Module`` containers, seeded init
on a device, and the bridge from the JAX package's parameter tree.

Weights keep the JAX layout ``(in, out)`` (``x @ W``), so the bridge is a
copy, never a transpose.  Init follows the reference's scheme
(``repro/models/params.py``): fan-in scaled truncated normal on [-2, 2]
(scale ``1 / sqrt(shape[0])``), norms at one.  Draws come from a
``torch.Generator``, so the numbers differ from JAX's for the same seed;
the tests bridge the JAX init instead."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none
    raises: an entry point never runs on the CPU unless told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class AttentionParams(nn.Module):
    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk = _frozen(wq), _frozen(wk)
        self.wv, self.wo = _frozen(wv), _frozen(wo)
        self.q_norm = None if q_norm is None else _frozen(q_norm)
        self.k_norm = None if k_norm is None else _frozen(k_norm)


class FFNParams(nn.Module):
    def __init__(self, wi_gate, wi_up, wo):
        super().__init__()
        self.wi_gate, self.wi_up = _frozen(wi_gate), _frozen(wi_up)
        self.wo = _frozen(wo)


class BlockParams(nn.Module):
    def __init__(self, ln1, ln2, attn: AttentionParams, ffn: FFNParams):
        super().__init__()
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn, self.ffn = attn, ffn


class DecoderParams(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V), and one
    :class:`BlockParams` per layer (the reference stacks them on a leading
    ``L`` axis for ``lax.scan``; here they are a list)."""

    def __init__(self, embed, final_norm, lm_head, blocks):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        self.blocks = nn.ModuleList(blocks)


class _Init:
    """Sequential seeded draws on one device."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.device = device

    def normal(self, *shape, scale: Optional[float] = None):
        if scale is None:
            scale = 1.0 / np.sqrt(shape[0] if len(shape) >= 2
                                  else max(shape[-1], 1))
        unit = torch.empty(shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(unit, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return (unit * scale).to(self.dtype)

    def ones(self, *shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)


def init_params(cfg, seed: int = 0, device=None) -> DecoderParams:
    """Seeded init of a dense decoder at ``cfg``'s widths, on ``device``
    (``None`` = the card)."""
    dev = resolve_device(device)
    ini = _Init(seed, DTYPES[cfg.dtype], dev)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = ini.normal(cfg.vocab_size, d)
    final_norm = ini.ones(d)
    lm_head = ini.normal(d, cfg.vocab_size)
    blocks = []
    for _ in range(cfg.n_layers):
        ln1, ln2 = ini.ones(d), ini.ones(d)
        attn = AttentionParams(
            ini.normal(d, h * hd), ini.normal(d, kv * hd),
            ini.normal(d, kv * hd), ini.normal(h * hd, d),
            *((ini.ones(hd), ini.ones(hd)) if cfg.qk_norm else ()))
        ffn = FFNParams(ini.normal(d, cfg.d_ff), ini.normal(d, cfg.d_ff),
                        ini.normal(cfg.d_ff, d))
        blocks.append(BlockParams(ln1, ln2, attn, ffn))
    return DecoderParams(embed, final_norm, lm_head, blocks)


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes: no numpy view in torch
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree, cfg, device) -> DecoderParams:
    """Bridge the JAX package's dense-decoder parameter tree (leaves
    already converted to numpy, e.g. ``jax.tree_util.tree_map(np.asarray,
    params)``) onto ``device``.  The stacked ``blocks`` leaves (leading
    ``L`` axis) are split into per-layer modules."""
    dev = torch.device(device)
    blk = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        a, f = blk["attn"], blk["ffn"]
        norms = (_tensor(a["q_norm"][i], dev), _tensor(a["k_norm"][i], dev)) \
            if cfg.qk_norm else ()
        attn = AttentionParams(*(_tensor(a[n][i], dev)
                                 for n in ("wq", "wk", "wv", "wo")), *norms)
        ffn = FFNParams(*(_tensor(f[n][i], dev)
                          for n in ("wi_gate", "wi_up", "wo")))
        blocks.append(BlockParams(_tensor(blk["ln1"][i], dev),
                                  _tensor(blk["ln2"][i], dev), attn, ffn))
    return DecoderParams(_tensor(tree["embed"], dev),
                         _tensor(tree["final_norm"], dev),
                         _tensor(tree["lm_head"], dev), blocks)
