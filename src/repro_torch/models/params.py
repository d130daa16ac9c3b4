"""Parameters of the ported model families (dense, MoE and MLA decoders,
the Qwen2-VL decoder, Mamba2, Zamba2, the Whisper encoder-decoder):
``nn.Module`` containers, seeded init on a device, and the bridge from the
JAX package's parameter tree.

Weights keep the JAX layout ``(in, out)`` (``x @ W``), so the bridge is a
copy, never a transpose.  Init follows the reference's scheme
(``repro/models/params.py``): fan-in scaled truncated normal on [-2, 2]
(scale ``1 / sqrt(shape[0])``), norms at one, biases at zero, and the
Mamba2 block's ``conv_b``, ``dt_bias``, ``a_log`` and ``d_skip`` at zero.
Draws come from a ``torch.Generator``, so the numbers differ from JAX's
for the same seed; the tests bridge the JAX init instead.

Every weight is built frozen (``requires_grad=False``), which serving
needs; a trainer unfreezes its own modules with ``requires_grad_(True)``.
:func:`flatten_params` and :func:`unflatten_params` carry a module to and
from ``/``-keyed tensors in the port's own names (``blocks/3/attn/wq``),
the keys of the optimizer state and the checkpoint.

Each container names the logical axes of its leaves in ``SPECS`` (the
reference's ``ParamCollector.add`` specs); :func:`param_specs` gives
``{flat name: logical axes}`` for a config, without the reference's
stacked ``"layers"`` axis since the port keeps one module per layer.
:func:`abstract_params` builds a config's parameters on
``torch.device("meta")`` (shapes and dtypes, no storage, no draws): the
dry run's and the roofline's parameters."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import options

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


def flatten_params(params: nn.Module) -> Dict[str, nn.Parameter]:
    """The module's parameters (the live tensors, not copies) keyed by
    their ``/``-joined module paths, e.g. ``blocks/3/attn/wq``."""
    return {name.replace(".", "/"): p
            for name, p in params.named_parameters()}


def unflatten_params(params: nn.Module, flat) -> nn.Module:
    """Copy ``flat`` (``/``-keyed tensors, as :func:`flatten_params` gives,
    on any device) into the module's parameters of those names, in place;
    every name, shape and dtype must match.  Returns the module."""
    own = flatten_params(params)
    if set(own) != set(flat):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(own) - set(flat))[:5]}, unexpected "
                       f"{sorted(set(flat) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            t = flat[name]
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                                 f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return params


class AttentionParams(nn.Module):
    SPECS = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
             "q_norm": ("head_dim",), "k_norm": ("head_dim",)}

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk = _frozen(wq), _frozen(wk)
        self.wv, self.wo = _frozen(wv), _frozen(wo)
        self.q_norm = None if q_norm is None else _frozen(q_norm)
        self.k_norm = None if k_norm is None else _frozen(k_norm)


class MHAParams(AttentionParams):
    """Whisper's attention: as many kv heads as heads, so wk / wv shard
    over ``heads`` as wq does (the reference's specs)."""

    SPECS = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
             "wv": ("embed", "heads"), "wo": ("heads", "embed")}


class FFNParams(nn.Module):
    SPECS = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
             "wo": ("mlp", "embed")}

    def __init__(self, wi_gate, wi_up, wo):
        super().__init__()
        self.wi_gate, self.wi_up = _frozen(wi_gate), _frozen(wi_up)
        self.wo = _frozen(wo)


class MoEFFNParams(nn.Module):
    """A routed expert FFN: router (d, E); wi_gate / wi_up (E, d, F); wo
    (E, F, d); with ``n_shared_experts`` a plain SwiGLU of width
    F * n_shared beside it: shared_wi_gate / shared_wi_up (d, F * n),
    shared_wo (F * n, d)."""

    NAMES = ("router", "wi_gate", "wi_up", "wo")
    SHARED = ("shared_wi_gate", "shared_wi_up", "shared_wo")
    SPECS = {"router": ("embed_no_fsdp", "experts"),
             "wi_gate": ("experts", "embed", "expert_mlp"),
             "wi_up": ("experts", "embed", "expert_mlp"),
             "wo": ("experts", "expert_mlp", "embed"),
             "shared_wi_gate": ("embed", "mlp"),
             "shared_wi_up": ("embed", "mlp"), "shared_wo": ("mlp", "embed")}

    def __init__(self, **leaves):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, _frozen(leaves[name]))
        self.shared = self.SHARED[0] in leaves
        for name in self.SHARED:
            setattr(self, name, _frozen(leaves[name]) if self.shared
                    else None)


class MLAParams(nn.Module):
    """Multi-head latent attention: w_dq (d, q_rank), q_norm (q_rank,),
    w_uq (q_rank, H (nope + rope)), w_dkv (d, rank + rope), kv_norm
    (rank,), w_uk (rank, H nope), w_uv (rank, H v), wo (H v, d)."""

    NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
             "wo")
    SPECS = {"w_dq": ("embed", "q_lora"), "q_norm": ("q_lora",),
             "w_uq": ("q_lora", "heads"), "w_dkv": ("embed", "kv_lora"),
             "kv_norm": ("kv_lora",), "w_uk": ("kv_lora", "heads"),
             "w_uv": ("kv_lora", "heads"), "wo": ("heads", "embed")}

    def __init__(self, **leaves):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, _frozen(leaves[name]))


class BlockParams(nn.Module):
    """ln1, ln2; ``attn`` an :class:`AttentionParams` or
    :class:`MLAParams`; ``ffn`` an :class:`FFNParams` or
    :class:`MoEFFNParams` (the block's kind, :func:`layer_kinds`)."""

    SPECS = {"ln1": ("embed_no_fsdp",), "ln2": ("embed_no_fsdp",)}

    def __init__(self, ln1, ln2, attn, ffn):
        super().__init__()
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn, self.ffn = attn, ffn


class DecoderParams(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V), one
    :class:`BlockParams` per layer (the reference stacks them on a leading
    ``L`` axis for ``lax.scan``; here they are a list), and before them
    the ``first_dense_layers`` prefix as ``head_blocks`` (the reference's
    ``head_block_{i}`` subtrees).  A ``vlm`` decoder also has
    ``vision_proj`` (vision_embed_dim, d), the projection of the patch
    embeddings into the text stream (None for the other families)."""

    SPECS = {"embed": ("vocab", "embed"), "final_norm": ("embed_no_fsdp",),
             "lm_head": ("embed", "vocab"),
             "vision_proj": ("embed_no_fsdp", "embed")}

    def __init__(self, embed, final_norm, lm_head, blocks, head_blocks=(),
                 vision_proj=None):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        self.head_blocks = nn.ModuleList(head_blocks)
        self.blocks = nn.ModuleList(blocks)
        self.vision_proj = None if vision_proj is None \
            else _frozen(vision_proj)


class MambaBlockParams(nn.Module):
    """One Mamba2 block: ln (d,), in_proj (d, 2 di + 2 G N + H), conv_w
    (W, C), conv_b (C,), dt_bias / a_log / d_skip (H,), out_norm (di,),
    out_proj (di, d)."""

    NAMES = ("ln", "in_proj", "conv_w", "conv_b", "dt_bias", "a_log",
             "d_skip", "out_norm", "out_proj")
    SPECS = {"ln": ("embed_no_fsdp",), "in_proj": ("embed", "mlp"),
             "conv_w": (None, "conv_dim"), "conv_b": ("conv_dim",),
             "dt_bias": (None,), "a_log": (None,), "d_skip": (None,),
             "out_norm": ("mlp",), "out_proj": ("mlp", "embed")}

    def __init__(self, **leaves):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, _frozen(leaves[name]))


class Mamba2Params(DecoderParams):
    """embed (V, d), final_norm (d,), lm_head (d, V), and one
    :class:`MambaBlockParams` per layer."""


class Zamba2Params(Mamba2Params):
    """A Mamba2 backbone plus ONE shared attention block (a
    :class:`BlockParams`: ln1, ln2, attention, SwiGLU FFN) whose weights
    every application site reuses."""

    def __init__(self, embed, final_norm, lm_head, shared: BlockParams,
                 blocks):
        super().__init__(embed, final_norm, lm_head, blocks)
        self.shared = shared


class GeluFFNParams(nn.Module):
    """Whisper's FFN: wi (d, F), bi (F,), wo (F, d), bo (d,)."""

    NAMES = ("wi", "bi", "wo", "bo")
    SPECS = {"wi": ("embed", "mlp"), "bi": ("mlp",), "wo": ("mlp", "embed"),
             "bo": ("embed_no_fsdp",)}

    def __init__(self, **leaves):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, _frozen(leaves[name]))


class EncoderBlockParams(nn.Module):
    """One Whisper encoder block (pre-LN): ln1_s / ln1_b and ln2_s / ln2_b
    (d,), ``attn`` an :class:`AttentionParams` (H = Hkv: wq / wk / wv
    (d, H D), wo (H D, d)), ``ffn`` a :class:`GeluFFNParams`."""

    NORMS = ("ln1_s", "ln1_b", "ln2_s", "ln2_b")
    SPECS = {"ln1_s": ("embed_no_fsdp",), "ln1_b": ("embed_no_fsdp",),
             "ln2_s": ("embed_no_fsdp",), "ln2_b": ("embed_no_fsdp",),
             "ln3_s": ("embed_no_fsdp",), "ln3_b": ("embed_no_fsdp",)}

    def __init__(self, attn, ffn, **norms):
        super().__init__()
        for name in self.NORMS:
            setattr(self, name, _frozen(norms[name]))
        self.attn, self.ffn = attn, ffn


class DecoderBlockParams(EncoderBlockParams):
    """One Whisper decoder block: an encoder block's leaves, plus ln3_s /
    ln3_b (d,) before the cross-attention ``cross`` (an
    :class:`AttentionParams` whose wk / wv read the encoder's memory)."""

    NORMS = EncoderBlockParams.NORMS + ("ln3_s", "ln3_b")

    def __init__(self, attn, ffn, cross, **norms):
        super().__init__(attn, ffn, **norms)
        self.cross = cross


class WhisperParams(nn.Module):
    """embed (V, d), an untied lm_head (d, V), the encoder's and the
    decoder's final LayerNorms enc_norm_s / enc_norm_b and dec_norm_s /
    dec_norm_b (d,), and one block module per layer in ``enc_blocks``
    and ``dec_blocks`` (the reference stacks each on a leading ``L``
    axis)."""

    OUTER = ("embed", "lm_head", "enc_norm_s", "enc_norm_b", "dec_norm_s",
             "dec_norm_b")
    SPECS = dict({"embed": ("vocab", "embed"),
                  "lm_head": ("embed", "vocab")},
                 **{n: ("embed_no_fsdp",) for n in OUTER[2:]})

    def __init__(self, enc_blocks, dec_blocks, **outer):
        super().__init__()
        for name in self.OUTER:
            setattr(self, name, _frozen(outer[name]))
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)


class _Init:
    """Sequential seeded draws on one device; on ``meta`` no draws, only
    shapes and dtypes (a generator cannot live there)."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device):
        self.gen = None if device.type == "meta" else \
            torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.device = device

    def normal(self, *shape, scale: Optional[float] = None):
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            scale = 1.0 / np.sqrt(shape[0] if len(shape) >= 2
                                  else max(shape[-1], 1))
        unit = torch.empty(shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(unit, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return (unit * scale).to(self.dtype)

    def ones(self, *shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def layer_kinds(cfg):
    """Each layer's kind, ``dense | moe | mla_dense | mla_moe``: MoE from
    layer ``first_dense_layers`` on when the config has experts, MLA
    everywhere when it uses MLA (the reference's ``_layer_kinds``)."""
    return [("mla_" if cfg.use_mla else "") +
            ("moe" if cfg.n_experts > 0 and i >= cfg.first_dense_layers
             else "dense") for i in range(cfg.n_layers)]


def _init_attention(ini: _Init, cfg) -> AttentionParams:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return AttentionParams(
        ini.normal(d, h * hd), ini.normal(d, kv * hd),
        ini.normal(d, kv * hd), ini.normal(h * hd, d),
        *((ini.ones(hd), ini.ones(hd)) if cfg.qk_norm else ()))


def _init_mla(ini: _Init, cfg) -> MLAParams:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vdim = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    rank, qrank = cfg.kv_lora_rank, cfg.q_lora_rank
    return MLAParams(
        w_dq=ini.normal(d, qrank), q_norm=ini.ones(qrank),
        w_uq=ini.normal(qrank, h * (nope + rope)),
        w_dkv=ini.normal(d, rank + rope), kv_norm=ini.ones(rank),
        w_uk=ini.normal(rank, h * nope), w_uv=ini.normal(rank, h * vdim),
        wo=ini.normal(h * vdim, d))


def _init_moe(ini: _Init, cfg) -> MoEFFNParams:
    """As the reference: every leaf fan-in scaled by its FIRST dimension,
    so the (E, ., .) expert weights by 1 / sqrt(E).  The router has all
    ``n_experts`` outputs, the expert weights the experts held."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    held = options(cfg).n_experts_held
    leaves = dict(router=ini.normal(d, e), wi_gate=ini.normal(held, d, f),
                  wi_up=ini.normal(held, d, f), wo=ini.normal(held, f, d))
    if cfg.n_shared_experts:
        sd = f * cfg.n_shared_experts
        leaves.update(shared_wi_gate=ini.normal(d, sd),
                      shared_wi_up=ini.normal(d, sd),
                      shared_wo=ini.normal(sd, d))
    return MoEFFNParams(**leaves)


def _init_block(ini: _Init, cfg, kind: str = "dense") -> BlockParams:
    """One block of ``kind`` (a dense block is also Zamba2's shared
    block)."""
    d = cfg.d_model
    ln1, ln2 = ini.ones(d), ini.ones(d)
    attn = _init_mla(ini, cfg) if kind.startswith("mla") \
        else _init_attention(ini, cfg)
    ffn = _init_moe(ini, cfg) if kind.endswith("moe") else FFNParams(
        ini.normal(d, cfg.d_ff), ini.normal(d, cfg.d_ff),
        ini.normal(cfg.d_ff, d))
    return BlockParams(ln1, ln2, attn, ffn)


def conv_channels(cfg) -> int:
    """Channels of a Mamba2 block's causal conv: x, B and C."""
    return cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state


def _init_mamba_block(ini: _Init, cfg) -> MambaBlockParams:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_n_heads
    conv_ch = conv_channels(cfg)
    gn = cfg.ssm_n_groups * cfg.ssm_state
    return MambaBlockParams(
        ln=ini.ones(d), in_proj=ini.normal(d, 2 * di + 2 * gn + h),
        conv_w=ini.normal(cfg.ssm_conv_width, conv_ch),
        conv_b=ini.zeros(conv_ch), dt_bias=ini.zeros(h), a_log=ini.zeros(h),
        d_skip=ini.zeros(h), out_norm=ini.ones(di),
        out_proj=ini.normal(di, d))


def _init_outer(ini: _Init, cfg):
    return (ini.normal(cfg.vocab_size, cfg.d_model), ini.ones(cfg.d_model),
            ini.normal(cfg.d_model, cfg.vocab_size))


def init_params(cfg, seed: int = 0, device=None) -> DecoderParams:
    """Seeded init of a dense, MoE, MLA or ``vlm`` decoder at ``cfg``'s
    widths, on ``device`` (``None`` = the card): the ``first_dense_layers``
    head blocks, then the tail (and a ``vlm`` decoder's ``vision_proj``)."""
    ini = _Init(seed, DTYPES[cfg.dtype], resolve_device(device))
    embed, final_norm, lm_head = _init_outer(ini, cfg)
    vision_proj = ini.normal(cfg.vision_embed_dim, cfg.d_model) \
        if cfg.family == "vlm" else None
    kinds = layer_kinds(cfg)
    blocks = [_init_block(ini, cfg, kind) for kind in kinds]
    n_head = cfg.first_dense_layers
    return DecoderParams(embed, final_norm, lm_head, blocks[n_head:],
                         blocks[:n_head], vision_proj)


def _init_whisper_block(ini: _Init, cfg, decoder: bool):
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim

    def attn():
        return MHAParams(ini.normal(d, hd), ini.normal(d, hd),
                         ini.normal(d, hd), ini.normal(hd, d))
    norms = {}
    for name in (DecoderBlockParams if decoder
                 else EncoderBlockParams).NORMS:
        norms[name] = ini.ones(d) if name.endswith("_s") else ini.zeros(d)
    self_attn = attn()
    ffn = GeluFFNParams(wi=ini.normal(d, cfg.d_ff), bi=ini.zeros(cfg.d_ff),
                        wo=ini.normal(cfg.d_ff, d), bo=ini.zeros(d))
    if decoder:
        return DecoderBlockParams(self_attn, ffn, attn(), **norms)
    return EncoderBlockParams(self_attn, ffn, **norms)


def init_whisper_params(cfg, seed: int = 0, device=None) -> WhisperParams:
    """Seeded init of a Whisper encoder-decoder at ``cfg``'s widths, on
    ``device`` (``None`` = the card): LayerNorm scales at one and every
    bias at zero, as the reference."""
    ini = _Init(seed, DTYPES[cfg.dtype], resolve_device(device))
    d = cfg.d_model
    outer = dict(embed=ini.normal(cfg.vocab_size, d),
                 lm_head=ini.normal(d, cfg.vocab_size),
                 enc_norm_s=ini.ones(d), enc_norm_b=ini.zeros(d),
                 dec_norm_s=ini.ones(d), dec_norm_b=ini.zeros(d))
    enc = [_init_whisper_block(ini, cfg, False)
           for _ in range(cfg.enc_layers)]
    dec = [_init_whisper_block(ini, cfg, True)
           for _ in range(cfg.dec_layers)]
    return WhisperParams(enc, dec, **outer)


def init_mamba2_params(cfg, seed: int = 0, device=None) -> Mamba2Params:
    """Seeded init of a Mamba2 LM at ``cfg``'s widths, on ``device``
    (``None`` = the card)."""
    ini = _Init(seed, DTYPES[cfg.dtype], resolve_device(device))
    embed, final_norm, lm_head = _init_outer(ini, cfg)
    blocks = [_init_mamba_block(ini, cfg) for _ in range(cfg.n_layers)]
    return Mamba2Params(embed, final_norm, lm_head, blocks)


def init_zamba2_params(cfg, seed: int = 0, device=None) -> Zamba2Params:
    """Seeded init of a Zamba2 hybrid at ``cfg``'s widths, on ``device``
    (``None`` = the card)."""
    ini = _Init(seed, DTYPES[cfg.dtype], resolve_device(device))
    embed, final_norm, lm_head = _init_outer(ini, cfg)
    shared = _init_block(ini, cfg)
    blocks = [_init_mamba_block(ini, cfg) for _ in range(cfg.n_layers)]
    return Zamba2Params(embed, final_norm, lm_head, shared, blocks)


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes: no numpy view in torch
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer(tree, i):
    """Layer ``i`` of a stacked parameter tree (leading ``L`` axis)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _bridge_block(blk, cfg, dev, kind: str = "dense") -> BlockParams:
    a, f = blk["attn"], blk["ffn"]
    if kind.startswith("mla"):
        attn = MLAParams(**{n: _tensor(a[n], dev) for n in MLAParams.NAMES})
    else:
        norms = (_tensor(a["q_norm"], dev), _tensor(a["k_norm"], dev)) \
            if cfg.qk_norm else ()
        attn = AttentionParams(*(_tensor(a[n], dev)
                                 for n in ("wq", "wk", "wv", "wo")), *norms)
    if kind.endswith("moe"):
        ffn = MoEFFNParams(**{n: _tensor(v, dev) for n, v in f.items()})
    else:
        ffn = FFNParams(*(_tensor(f[n], dev)
                          for n in ("wi_gate", "wi_up", "wo")))
    return BlockParams(_tensor(blk["ln1"], dev), _tensor(blk["ln2"], dev),
                       attn, ffn)


def _bridge_whisper(tree, cfg, dev) -> WhisperParams:
    def attn(a):
        return MHAParams(*(_tensor(a[n], dev)
                           for n in ("wq", "wk", "wv", "wo")))

    def block(b, cls):
        kw = {n: _tensor(b[n], dev) for n in cls.NORMS}
        ffn = GeluFFNParams(**{n: _tensor(b["ffn"][n], dev)
                               for n in GeluFFNParams.NAMES})
        if cls is DecoderBlockParams:
            kw["cross"] = attn(b["cross"])
        return cls(attn(b["attn"]), ffn, **kw)

    return WhisperParams(
        [block(_layer(tree["enc_blocks"], i), EncoderBlockParams)
         for i in range(cfg.enc_layers)],
        [block(_layer(tree["dec_blocks"], i), DecoderBlockParams)
         for i in range(cfg.dec_layers)],
        **{n: _tensor(tree[n], dev) for n in WhisperParams.OUTER})


def from_jax_params(tree, cfg, device):
    """Bridge the JAX package's parameter tree of a ``dense``, ``moe``
    (MoE, and MLA + MoE), ``vlm`` (Qwen2-VL), ``ssm`` (Mamba2), ``hybrid``
    (Zamba2) or ``encdec`` (Whisper) model (leaves already converted to
    numpy, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) onto
    ``device``.  The stacked ``blocks`` leaves (Whisper: ``enc_blocks``
    and ``dec_blocks``; leading ``L`` axis) are split into per-layer
    modules, the ``head_block_{i}`` subtrees become the head blocks;
    Zamba2's ``shared`` block is taken as it is."""
    dev = torch.device(device)
    if cfg.family == "encdec":
        return _bridge_whisper(tree, cfg, dev)
    outer = (_tensor(tree["embed"], dev), _tensor(tree["final_norm"], dev),
             _tensor(tree["lm_head"], dev))
    blk = tree["blocks"]
    if cfg.family in ("dense", "moe", "vlm"):
        kinds = layer_kinds(cfg)
        n_head = cfg.first_dense_layers
        head = [_bridge_block(tree[f"head_block_{i}"], cfg, dev, kinds[i])
                for i in range(n_head)]
        vision_proj = _tensor(tree["vision_proj"], dev) \
            if cfg.family == "vlm" else None
        return DecoderParams(*outer, [
            _bridge_block(_layer(blk, i), cfg, dev, kinds[-1])
            for i in range(cfg.n_layers - n_head)], head, vision_proj)
    mamba = [MambaBlockParams(**{n: _tensor(blk[n][i], dev)
                                 for n in MambaBlockParams.NAMES})
             for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return Mamba2Params(*outer, mamba)
    if cfg.family == "hybrid":
        return Zamba2Params(*outer, _bridge_block(tree["shared"], cfg, dev),
                            mamba)
    raise ValueError(f"unknown model family {cfg.family!r}")


_INITS = {"dense": init_params, "moe": init_params, "vlm": init_params,
          "ssm": init_mamba2_params, "hybrid": init_zamba2_params,
          "encdec": init_whisper_params}


def meta(shape, dtype=torch.int32) -> torch.Tensor:
    """A stand-in tensor of ``shape`` on ``meta`` (the dry run's inputs)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_inputs(shape):
    """The token-only models' inputs: ``(meta tensors, logical axes)`` of
    a ``ShapeSpec`` — tokens (B, S) to train or prefill; tokens (B, 1) and
    cache_len (B,) to decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"tokens": meta((b, s))}, {"tokens": ("batch", "seq")}
    return ({"tokens": meta((b, 1)), "cache_len": meta((b,))},
            {"tokens": ("batch", None), "cache_len": ("batch",)})


def module_specs(params: nn.Module) -> Dict[str, tuple]:
    """``{flat name: logical axes}`` of every parameter of ``params``, from
    the ``SPECS`` of the container that holds it."""
    out = {}
    for prefix, mod in params.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            out[name.replace(".", "/")] = type(mod).SPECS[leaf]
    return out


def abstract_params(cfg):
    """``(params, specs)``: ``cfg``'s parameters on ``meta`` (no storage,
    no draws) and their logical axes."""
    if cfg.family not in _INITS:
        raise ValueError(f"unknown model family {cfg.family!r}")
    params = _INITS[cfg.family](cfg, 0, "meta")
    return params, module_specs(params)


def param_specs(cfg) -> Dict[str, tuple]:
    """``{flat name: logical axes}`` of ``cfg``'s parameters, under the
    port's names (``blocks/3/attn/wq``): the reference's specs without
    the stacked ``"layers"`` axis."""
    return abstract_params(cfg)[1]
