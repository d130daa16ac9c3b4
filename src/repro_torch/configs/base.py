"""Config system: one dataclass covers the whole zoo; every assigned arch is
an instance in its own module (``repro/configs/<id>.py``) with the exact
published hyper-parameters; ``reduced()`` derives the same-family smoke-test
config (small dims, CPU-runnable)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_chunk: int = 512          # blockwise-attention KV chunk
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    # hybrid (Zamba2): one *shared* attention block applied every k layers
    shared_attn_every: int = 0
    # enc-dec (Whisper): backbone only; conv frontend is a stub
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq: int = 1500
    use_rope: bool = True
    # VLM (Qwen2-VL): vision frontend is a stub (precomputed patch embeds)
    mrope_sections: Tuple[int, ...] = ()
    vision_embed_dim: int = 0
    vision_frac: float = 0.25      # fraction of seq that is vision tokens
    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"            # full | none
    scan_layers: bool = True       # False → unrolled (dry-run fidelity)
    optimizer: str = "adamw"       # adamw | adafactor
    # capability flags
    subquadratic: bool = False     # may run long_500k
    has_decoder: bool = True

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Same-family smoke config: tiny dims, CPU-runnable in seconds."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            attn_chunk=32,
        )
        if self.family in ("moe",):
            kw.update(n_experts=8, top_k=2, expert_d_ff=32,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16, head_dim=16)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(n_layers=4, shared_attn_every=2, n_kv_heads=4)
        if self.family == "encdec":
            kw.update(enc_layers=2, dec_layers=2, enc_seq=32)
        if self.family == "vlm":
            kw.update(vision_embed_dim=32, mrope_sections=(2, 3, 3))
        return self.replace(**kw)

    # convenience dims ---------------------------------------------------
    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def shapes(self) -> Dict[str, ShapeSpec]:
        """The assigned shape grid for this arch (with documented skips)."""
        out = {}
        for name, s in SHAPES.items():
            if name == "long_500k" and not self.subquadratic:
                continue  # full-attention arch: skip per assignment note
            if s.kind == "decode" and not self.has_decoder:
                continue
            out[name] = s
        return out


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the arch modules lazily so registration happens on demand
    from . import ALL_ARCHS  # noqa: F401  (side-effect imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    from . import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)
