"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-arch small dense LM."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
))
