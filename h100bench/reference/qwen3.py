"""Qwen3's dense decoder in plain PyTorch and fp32, from the published
equations (Qwen3 technical report, arXiv:2505.09388, and the model's
``config.json``): RMSNorm (eps from the config) before attention and MLP,
q and k each RMS-normed per head before rotary embeddings (rotate-half
form, base ``rope_theta``), grouped-query attention with 1/sqrt(D)
scaling and a causal mask, a SwiGLU MLP, a final RMSNorm and an untied
output head.  No bias anywhere, no sliding window.

Weights arrive as a :class:`Weights` of device tensors in the ``x @ W``
layout, in whatever type they are served in; each layer is upcast to fp32
(``quant`` first rounds it to a lower precision: the control) only while
it runs, so a model whose fp32 copy would not fit beside the served one is
run one layer at a time.  Matrix products run with TF32 off.  The control
(``quant="fp8"``) is the same computation in fp8: every weight and every
product's input rounded to float8 e4m3 with per-channel (weights) and
per-token (inputs) scales, sums in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
              "w_gate", "w_up", "w_down")


@dataclass
class Weights:
    embed: torch.Tensor          # (V, d)
    final_norm: torch.Tensor     # (d,)
    lm_head: torch.Tensor        # (d, V)
    layers: List[Dict[str, torch.Tensor]]   # LAYER_KEYS each


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int):
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to e4m3's largest, 448), back in
    fp32."""
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _up(w, quant: Optional[str], rows_are_channels: bool = False):
    """A weight in fp32, or for the control rounded to fp8 with a scale per
    output channel (columns of an ``x @ W`` matrix, rows of an embedding
    table); norm gains stay as they are."""
    if quant is None or w.dim() == 1:
        return w.float()
    if quant == "fp8":
        return fp8(w, 1 if rows_are_channels else 0)
    raise ValueError(f"unknown quant {quant!r}")


def _mm(x, w, quant: Optional[str]):
    """x @ w; for the fp8 control each row of x (a token) is rounded to fp8
    with its own scale first, as fp8 inference feeds its products."""
    return (fp8(x, -1) if quant == "fp8" else x) @ w


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x (S, H, D) rotated at ``positions`` (S,), rotate-half form."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = (positions.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, q_block: int = 512):
    """q (S, H, D), k / v (S, Hkv, D) → (S, H, D), query blocks of
    ``q_block`` rows so the score matrix stays small."""
    s, h, d = q.shape
    g = h // k.shape[1]
    kx = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, S, D)
    vx = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, q_block):
        b = min(s, a + q_block)
        sc = torch.einsum("qhd,hkd->hqk", q[a:b], kx[:, :b]) / math.sqrt(d)
        mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(sc, dim=-1),
                                vx[:, :b])
    return out


def block(x, w: Dict[str, torch.Tensor], cfg: dict, positions,
          quant: Optional[str] = None):
    """One decoder layer over x (S, d), fp32 (the control's products take
    fp8 inputs)."""
    h_, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    s = x.shape[0]
    h = rms_norm(x, w["ln1"], eps)
    q = _mm(h, w["wq"], quant).view(s, h_, hd)
    k = _mm(h, w["wk"], quant).view(s, hkv, hd)
    v = _mm(h, w["wv"], quant).view(s, hkv, hd)
    q = rope(rms_norm(q, w["q_norm"], eps), positions, cfg["rope_theta"])
    k = rope(rms_norm(k, w["k_norm"], eps), positions, cfg["rope_theta"])
    x = x + _mm(causal_attention(q, k, v).reshape(s, h_ * hd), w["wo"],
                quant)
    h = rms_norm(x, w["ln2"], eps)
    gate = _mm(h, w["w_gate"], quant)
    act = gate * torch.sigmoid(gate) * _mm(h, w["w_up"], quant)
    return x + _mm(act, w["w_down"], quant)


def logits_at(weights: Weights, cfg: dict, seqs: Sequence[torch.Tensor],
              want: Sequence[torch.Tensor], quant: Optional[str] = None,
              on_layer: Optional[Callable[[int], None]] = None):
    """fp32 logits of each sequence in ``seqs`` (1-D token tensors) at the
    positions ``want`` names (1-D index tensors, one per sequence):
    a list of (len(want[i]), V) tensors.  Layer by layer over all
    sequences, so only one layer's fp32 weights live at a time."""
    dev = weights.embed.device
    table = weights.embed
    hs = [_up(table[s.to(dev)], quant, rows_are_channels=True)
          for s in seqs]
    pos = [torch.arange(s.shape[0], device=dev) for s in seqs]
    for i, layer in enumerate(weights.layers):
        w = {k: _up(layer[k], quant) for k in LAYER_KEYS}
        hs = [block(h, w, cfg, p, quant) for h, p in zip(hs, pos)]
        del w
        if on_layer is not None:
            on_layer(i)
    norm = weights.final_norm.float()
    head = _up(weights.lm_head, quant)
    eps = cfg["rms_norm_eps"]
    return [_mm(rms_norm(h[idx.to(dev)], norm, eps), head, quant)
            for h, idx in zip(hs, want)]
