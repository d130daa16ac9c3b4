"""Llama-3-405B [arXiv:2407.21783] — frontier dense GQA.

Memory note (DESIGN.md §4): bf16 params + fp32 Adam m/v ≈ 5.7 TB — exceeds a
256×16 GB v5e pod, so the train config defaults to Adafactor (factored second
moment, bf16 accumulators) fully sharded over (pod, data, model)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    optimizer="adafactor",
))
