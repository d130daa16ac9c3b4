"""Mamba2 (SSD, state-space duality) blocks and model, ported from the JAX
package's ``models/ssm.py``.

The full-sequence path runs the chunked dual form through the SSD kernel
(:func:`repro_torch.kernels.ops.ssd`, whose plain version is
``ssd_chunked_ref``); decode keeps an O(1) recurrent state, updated in plain
PyTorch as the reference computes it outside any kernel.  The decode cache
is ``{"ssm": (L, B, H, P, N) fp32, "conv": (L, B, W-1, C)}``, updated in
place."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.dtensor_ops import is_dtensor, shard_local, unshard, \
    view_local
from ..parallel.sharding import constrain
from .layers import embed, lm_loss, remat, rms_norm, zero_pad
from .params import (
    DTYPES,
    Mamba2Params,
    abstract_params,
    conv_channels,
    init_mamba2_params,
    resolve_device,
    token_inputs,
)

# the recurrent state's heads shard over 'model', beside the TP-sharded
# inner activations (the reference's choice)
SSM_CACHE_SPECS = {"ssm": ("layers", "batch", "act_heads", None, None),
                   "conv": ("layers", "batch", None, "conv_dim")}


def _split_in_proj(cfg, proj):
    """proj (..., 2 di + 2 G N + H) → z (di), conv-in (di + 2 G N),
    dt (H).  Under a mesh the split points are not shard bounds, so the
    last dimension is gathered first (:func:`unshard`)."""
    proj = unshard(proj, -1)
    di = cfg.d_inner
    gn = cfg.ssm_n_groups * cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * gn], \
        proj[..., 2 * di + 2 * gn:]


def _causal_conv_train(conv_in, w, b):
    """Depthwise causal conv over the sequence: conv_in (B,S,C), w (W,C);
    under a mesh the taps are gathered like conv_in (a few KB)."""
    w, b = unshard(w, -1), unshard(b, -1)
    width, s = w.shape[0], conv_in.shape[1]
    pad = zero_pad(conv_in, 1, before=width - 1)
    out = sum(pad[:, i:i + s] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b[None, None, :])


def _split_conv(cfg, conv_out):
    """conv_out (..., C) → x (..., di), B (..., G N), C (..., G N), the
    last dimension gathered first under a mesh, as for in_proj."""
    conv_out = unshard(conv_out, -1)
    di = cfg.d_inner
    gn = cfg.ssm_n_groups * cfg.ssm_state
    return conv_out[..., :di], conv_out[..., di:di + gn], \
        conv_out[..., di + gn:]


def _head_split(cfg, in_proj):
    """The mesh dimensions that split the scan's heads: those that split
    in_proj's last dimension (``"mlp"``), where H divides over them and
    the groups split alike or are one; none for a plain in_proj."""
    if not is_dtensor(in_proj):
        return []
    mesh = in_proj.device_mesh
    dims = [i for i, p in enumerate(in_proj.placements) if p.is_shard(1)]
    n = 1
    for i in dims:
        n *= mesh.size(i)
    h, g = cfg.ssm_n_heads, cfg.ssm_n_groups
    return dims if h % n == 0 and (g == 1 or g % n == 0) else []


def mamba_block_train(p, cfg, x):
    """One Mamba2 block over a full sequence; x (B,S,d) → (B,S,d).

    Under a mesh the scan runs on each rank's heads: xs and dt, whole
    after the gathered conv, are split on the head dimension over the
    mesh dimensions that split in_proj's ``"mlp"`` (:func:`_head_split`),
    y comes back split so, its (B,S,di) view split on di in contiguous
    blocks as out_norm and out_proj's rows are, z is sliced alike, the
    gated norm reduces across the split and ``y @ out_proj`` is a partial
    sum that the final constraint resolves."""
    b, s, _ = x.shape
    h = rms_norm(x, p.ln)
    z, conv_in, dt = _split_in_proj(cfg, h @ p.in_proj)
    xs, bmat, cmat = _split_conv(
        cfg, _causal_conv_train(conv_in, p.conv_w, p.conv_b))
    heads = _head_split(cfg, p.in_proj)
    xs = shard_local(xs.reshape(b, s, cfg.ssm_n_heads, cfg.ssm_head_dim),
                     2, heads)
    bmat = bmat.reshape(b, s, cfg.ssm_n_groups, cfg.ssm_state)
    cmat = cmat.reshape(b, s, cfg.ssm_n_groups, cfg.ssm_state)
    dt = shard_local(F.softplus(dt.float() + p.dt_bias), 2, heads)
    a = -torch.exp(p.a_log.float())
    y, _ = ops.ssd(xs.contiguous(), dt, a, bmat.contiguous(),
                   cmat.contiguous(), chunk=cfg.ssm_chunk, d_skip=p.d_skip)
    y = view_local(y, (b, s, cfg.d_inner)) * F.silu(shard_local(z, 2, heads))
    y = rms_norm(y, p.out_norm)
    return constrain(x + y @ p.out_proj, "batch", "seq", "act_embed")


def mamba_block_decode(p, cfg, x, ssm_state, conv_state):
    """One token: x (B,1,d); ssm_state (B,H,P,N) fp32 and conv_state
    (B,W-1,C), both updated in place.  Returns the block's output."""
    bsz = x.shape[0]
    h = rms_norm(x, p.ln)
    z, conv_in, dt = _split_in_proj(cfg, (h @ p.in_proj)[:, 0])
    # causal conv with the cached history
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p.conv_w) +
                      p.conv_b)
    conv_state.copy_(window[:, 1:])
    hg = cfg.ssm_n_heads // cfg.ssm_n_groups
    xs, bmat, cmat = _split_conv(cfg, conv_out)
    xf = xs.reshape(bsz, cfg.ssm_n_heads, cfg.ssm_head_dim).float()
    bmat = bmat.reshape(bsz, cfg.ssm_n_groups, cfg.ssm_state) \
        .repeat_interleave(hg, dim=1).float()                    # (B,H,N)
    cmat = cmat.reshape(bsz, cfg.ssm_n_groups, cfg.ssm_state) \
        .repeat_interleave(hg, dim=1).float()
    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,H)
    a = -torch.exp(p.a_log.float())
    da = torch.exp(dt * a[None, :])
    ssm_state.mul_(da[..., None, None]).add_(
        (dt[..., None, None] * xf[..., None]) * bmat[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, cmat)
    y = y + xf * p.d_skip.float()[None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None, :]), p.out_norm)
    return x + y @ p.out_proj


def init_ssm_cache(cfg, batch_size: int, device) -> Dict[str, torch.Tensor]:
    """Zeroed recurrent state {"ssm": (L,B,H,P,N) fp32, "conv":
    (L,B,W-1,C) in the model's dtype}."""
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_n_heads,
                            cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch_size,
                             cfg.ssm_conv_width - 1, conv_channels(cfg)),
                            dtype=DTYPES[cfg.dtype], device=dev),
    }


class Mamba2LM:
    """Attention-free SSD language model (mamba2-1.3b)."""

    def __init__(self, cfg):
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2LM needs an 'ssm' config, got "
                             f"{cfg.family!r}")
        self.cfg = cfg

    def init(self, seed: int = 0, device=None) -> Mamba2Params:
        """Seeded weights on ``device`` (``None`` = the card)."""
        return init_mamba2_params(self.cfg, seed, device)

    def abstract_params(self):
        """``(params, specs)``: the parameters on ``meta`` and their logical
        axes (:func:`repro_torch.models.params.abstract_params`)."""
        return abstract_params(self.cfg)

    def logits_fn(self, params: Mamba2Params, batch):
        """Full-sequence forward → (logits (B,S,V), labels); under grad
        each block is rematerialised (:func:`layers.remat`)."""
        tokens = batch["tokens"]
        x = constrain(embed(params.embed, tokens), "batch", "seq",
                      "act_embed")
        block = remat(mamba_block_train, self.cfg)
        for blk in params.blocks:
            x = block(blk, self.cfg, x)
        x = rms_norm(x, params.final_norm)
        return constrain(x @ params.lm_head, "batch", "seq", "act_vocab"), \
            tokens

    def loss_fn(self, params: Mamba2Params, batch):
        """Mean next-token cross-entropy over ``batch`` (fp32 scalar)."""
        return lm_loss(*self.logits_fn(params, batch))

    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zeroed recurrent state (``max_len`` is unused: the state does
        not grow with the sequence)."""
        del max_len
        return init_ssm_cache(self.cfg, batch_size, device)

    def cache_specs(self) -> Dict[str, tuple]:
        """The logical axes of each :meth:`init_cache` entry."""
        return dict(SSM_CACHE_SPECS)

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins of every model input (the dry run)."""
        return token_inputs(shape)[0]

    def input_axes(self, shape) -> Dict[str, tuple]:
        return token_inputs(shape)[1]

    def decode_step(self, params: Mamba2Params, cache, batch):
        """One token for every sequence.  batch: tokens (B,1) (a
        ``cache_len`` is accepted and unused).  Returns (logits (B,V),
        cache); the cache is updated in place."""
        x = constrain(embed(params.embed, batch["tokens"]),    # (B,1,d)
                      "batch", None, "act_embed")
        for i, blk in enumerate(params.blocks):
            x = mamba_block_decode(blk, self.cfg, x, cache["ssm"][i],
                                   cache["conv"][i])
        x = rms_norm(x, params.final_norm)
        return constrain(x[:, 0] @ params.lm_head, "batch", "act_vocab"), \
            cache
