"""The served model's weights, made on the device from ``--seed``.

Every matrix of one fan-in shares one buffer, filled by a few large
``normal_`` calls of one ``torch.Generator`` on the device in the served
type, so the same seed gives the same bytes and making 61 GiB takes
seconds.  Leaves are views into those buffers.  Scales: a matrix fed by a
width n draws N(0, 1/n) (the port's own fan-in rule), the embedding
N(0, 1), norm gains 1 + N(0, 0.1^2) so that each norm's gain is checked
too.  The program and
the reference get the same tensors: the program as its parameter
containers, the reference as a :class:`reference.qwen3.Weights` view.
"""

from __future__ import annotations

import math

import torch

from reference.qwen3 import Weights

FILL_CHUNK = 1 << 28          # elements a normal_ call fills


def _fill(buf: torch.Tensor, std: float, gen: torch.Generator,
          mean: float = 0.0) -> None:
    flat = buf.view(-1)
    for a in range(0, flat.numel(), FILL_CHUNK):
        flat[a:a + FILL_CHUNK].normal_(mean, std, generator=gen)


class _Carver:
    """Hands out consecutive views of one flat buffer."""

    def __init__(self, buf: torch.Tensor):
        self.buf, self.at = buf, 0

    def take(self, *shape) -> torch.Tensor:
        n = math.prod(shape)
        out = self.buf[self.at:self.at + n].view(*shape)
        self.at += n
        return out


def make_weights(cfg: dict, seed: int, device, dtype) -> Weights:
    """Seeded Qwen3 weights of the configuration ``cfg`` (its published
    keys) on ``device`` in ``dtype``."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    per_in_d = d * (h * hd + 2 * hkv * hd + 2 * f)

    def buffer(n, std, mean=0.0):
        buf = torch.empty(n, dtype=dtype, device=device)
        _fill(buf, std, gen, mean)
        return _Carver(buf)

    from_d = buffer(L * per_in_d + d * v, 1.0 / math.sqrt(d))
    from_heads = buffer(L * h * hd * d, 1.0 / math.sqrt(h * hd))
    from_mlp = buffer(L * f * d, 1.0 / math.sqrt(f))
    table = buffer(v * d, 1.0)
    gains = buffer(L * (2 * d + 2 * hd) + d, 0.1, mean=1.0)
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
