"""Qwen2-VL-72B [arXiv:2409.12191] — text backbone with M-RoPE; dynamic-
resolution vision frontend is a STUB (input_specs() provides precomputed
patch embeddings at the ViT output width, 1280)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),
    vision_embed_dim=1280,
    vision_frac=0.25,
    rope_theta=1000000.0,
))
