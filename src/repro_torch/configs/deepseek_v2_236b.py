"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora=512) + 160-expert
top-6 MoE with 2 shared experts; first layer dense (d_ff 12288)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: heads share the compressed cache
    head_dim=192,          # nope(128) + rope(64)
    d_ff=12288,            # dense-layer FFN width
    expert_d_ff=1536,
    vocab_size=102400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
))
