"""The yardstick's arithmetic: the card's peaks, the least time a call can
take, the operations and bytes of a paged attention call, and the model
FLOPs of a token.

``bound`` and the peaks above it are copies of ``chip_smoke.py``'s,
unchanged in arithmetic, kept here so the yardstick does not move when
the smoke script does.  Bytes count each input byte read once and each
output byte written once; operations count two per multiply-add.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
# fp32 at 165 TFLOP/s: the 3xTF32 kernels do fp32-accurate work on the
# tensor cores at 495 / 3 (three TF32 products a product), above the
# card's 67 TFLOP/s of fp32 FMA, so that is the least time for fp32 work.
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}

PAGED = re.compile(r"\bpaged_(mma|partial|combine)_kernel\b")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------- attention calls

def paged_call(ctx, n_heads: int, n_kv_heads: int, head_dim: int,
               elt: int):
    """(bytes, operations) of one paged decode attention call over the
    occupied rows' context lengths ``ctx`` (host ints, each counting the
    row's new token): each row reads its keys and values once for every
    kv head, reads its query and writes its output."""
    keys = sum(ctx)
    rows = len(ctx)
    nbytes = keys * 2 * n_kv_heads * head_dim * elt + \
        rows * 2 * n_heads * head_dim * elt
    flops = 4 * n_heads * head_dim * keys
    return nbytes, flops


# ------------------------------------------------------------ model FLOPs

def layer_params(cfg: dict) -> int:
    """Matrix parameters of one Qwen3 layer (norm gains left out)."""
    d, h, hkv, hd = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"], cfg["head_dim"]
    return d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * cfg["intermediate_size"]


def token_flops(cfg: dict, n_tokens: int, attended_keys: int,
                head_rows: int) -> float:
    """Model FLOPs of ``n_tokens`` tokens through every layer (2 per
    matrix parameter a token), their attention over ``attended_keys`` keys
    in all (summed over tokens, per layer), and the output head on
    ``head_rows`` rows."""
    L = cfg["num_hidden_layers"]
    attn = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * attended_keys
    return (2.0 * layer_params(cfg) * n_tokens + attn) * L + \
        2.0 * cfg["hidden_size"] * cfg["vocab_size"] * head_rows
