"""Qwen3's dense decoder (``model_type`` "qwen3"): what the harness needs
of the architecture, found by :func:`hb_cell.arch_of`.

Weights: a matrix fed by a width n draws N(0, 1/n) (the port's own fan-in
rule), the embedding N(0, 1), norm gains 1 + N(0, 0.1^2) so that each
norm's gain is checked too.  The program and the reference get the same
tensors: the program as its parameter containers, the reference as a
:class:`reference.qwen3.Weights` view.

Counts: operations are two a multiply-add; bytes count each input byte
read once and each output byte written once.
"""

from __future__ import annotations

import math
import re

import torch

from hb_weights import buffer
from reference import qwen3 as reference
from reference.qwen3 import Weights

# the paged decode kernels of ``repro_torch.kernels.ops.paged_attention``
DECODE_KERNELS = re.compile(r"\bpaged_(mma|partial|combine)_kernel\b")


def make_weights(cfg: dict, seed: int, device, dtype) -> Weights:
    """Seeded weights of the configuration ``cfg`` (its published keys) on
    ``device`` in ``dtype``."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    per_in_d = d * (h * hd + 2 * hkv * hd + 2 * f)

    def buf(n, std, mean=0.0):
        return buffer(n, std, gen, device, dtype, mean)

    from_d = buf(L * per_in_d + d * v, 1.0 / math.sqrt(d))
    from_heads = buf(L * h * hd * d, 1.0 / math.sqrt(h * hd))
    from_mlp = buf(L * f * d, 1.0 / math.sqrt(f))
    table = buf(v * d, 1.0)
    gains = buf(L * (2 * d + 2 * hd) + d, 0.1, mean=1.0)
    layers = []
    for _ in range(L):
        layers.append({
            "wq": from_d.take(d, h * hd), "wk": from_d.take(d, hkv * hd),
            "wv": from_d.take(d, hkv * hd), "w_gate": from_d.take(d, f),
            "w_up": from_d.take(d, f), "wo": from_heads.take(h * hd, d),
            "w_down": from_mlp.take(f, d), "ln1": gains.take(d),
            "ln2": gains.take(d), "q_norm": gains.take(hd),
            "k_norm": gains.take(hd)})
    return Weights(embed=table.take(v, d), final_norm=gains.take(d),
                   lm_head=from_d.take(d, v), layers=layers)


def program_params(weights: Weights):
    """The same tensors as the port's ``DecoderParams`` (no copy)."""
    from repro_torch.models.params import (AttentionParams, BlockParams,
                                           DecoderParams, FFNParams)
    blocks = [BlockParams(
        w["ln1"], w["ln2"],
        AttentionParams(w["wq"], w["wk"], w["wv"], w["wo"], w["q_norm"],
                        w["k_norm"]),
        FFNParams(w["w_gate"], w["w_up"], w["w_down"]))
        for w in weights.layers]
    return DecoderParams(weights.embed, weights.final_norm,
                         weights.lm_head, blocks)


def model_config(cfg: dict, dtype: str):
    """The port's ``ModelConfig`` for the published keys of ``cfg``."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        qk_norm=True, rope_theta=float(cfg["rope_theta"]), dtype=dtype)


# the published keys that the port's registry config holds, by its names
_PORT_WIDTHS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                "num_attention_heads": "n_heads",
                "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
                "intermediate_size": "d_ff", "vocab_size": "vocab_size"}


def port_widths(cfg: dict) -> dict:
    """{published key: the port ``ModelConfig``'s field} for every key
    that the port's registry config of ``cfg["name"]`` must equal, leaving
    out the keys that ``cfg["reduced"]`` lists."""
    cut = set(cfg.get("reduced", ()))
    return {k: a for k, a in _PORT_WIDTHS.items() if k not in cut}


def tiny(cfg: dict) -> dict:
    """``cfg`` at a width and depth the CPU serves in seconds: eight layers
    of width 128.  (At two layers of width 64 a decode step that leaves
    the pages unchanged reads 0.30-0.65, about the cell's limit; at eight
    of 128, 0.53 and more.)"""
    return {**cfg, "hidden_size": 128, "intermediate_size": 384,
            "num_attention_heads": 8, "num_key_value_heads": 2,
            "head_dim": 16, "num_hidden_layers": 8, "vocab_size": 512}


def layer_params(cfg: dict) -> int:
    """Matrix parameters of one layer (norm gains left out)."""
    d, h, hkv, hd = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"], cfg["head_dim"]
    return d * (h + 2 * hkv) * hd + h * hd * d + \
        3 * d * cfg["intermediate_size"]


def token_flops(cfg: dict, n_tokens: int, attended_keys: int,
                head_rows: int) -> float:
    """Model FLOPs of ``n_tokens`` tokens through every layer (2 per
    matrix parameter a token: every parameter is active), their attention
    over ``attended_keys`` keys in all (summed over tokens, per layer),
    and the output head on ``head_rows`` rows."""
    L = cfg["num_hidden_layers"]
    attn = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * attended_keys
    return (2.0 * layer_params(cfg) * n_tokens + attn) * L + \
        2.0 * cfg["hidden_size"] * cfg["vocab_size"] * head_rows


def decode_attention_work(cfg: dict, rows: int, keys: int, elt: int):
    """(bytes, operations) of paged decode attention in every layer for
    ``rows`` occupied decode rows (summed over steps) whose context
    lengths, each counting the row's new token, sum to ``keys``; ``elt``
    bytes an element.  In each layer each row reads its keys and values
    once for every kv head, reads its query and writes its output."""
    L = cfg["num_hidden_layers"]
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    nbytes = keys * 2 * hkv * hd * elt + rows * 2 * h * hd * elt
    flops = 4 * h * hd * keys
    return L * nbytes, L * flops
