"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + one *shared* attention
block (32 heads, d_ff 8192) applied every 6 layers.

Sub-quadratic in history per decode step → runs long_500k."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,             # shared block's MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_n_groups=1,
    ssm_chunk=128,
    shared_attn_every=6,
    rope_theta=10000.0,
    subquadratic=True,
))
