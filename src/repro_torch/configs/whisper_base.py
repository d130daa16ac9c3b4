"""Whisper-base [arXiv:2212.04356] — enc-dec backbone; the conv audio
frontend is a STUB: input_specs() provides precomputed frame embeddings."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=12,           # 6 enc + 6 dec
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    enc_seq=1500,
    use_rope=False,        # sinusoidal (enc) / learned (dec) positions
))
