"""Qwen3-32B [hf:Qwen/Qwen3-8B family] — dense GQA with qk-norm."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
))
