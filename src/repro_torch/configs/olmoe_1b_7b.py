"""OLMoE-1B-7B [arXiv:2409.02060] — 64-expert top-8 MoE."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,             # == expert FFN width (assignment spec)
    expert_d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    rope_theta=10000.0,
))
