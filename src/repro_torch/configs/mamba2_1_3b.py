"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality).

Sub-quadratic: runs the long_500k decode cell (O(1) recurrent state)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                # attention-free, no FFN block (Mamba2 arch)
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_n_groups=1,
    ssm_chunk=128,
    subquadratic=True,
))
