"""DeepSeek-V2 (``model_type`` "deepseek_v2"): multi-head latent attention
with YaRN rope, a leading dense layer, then expert layers of routed
experts (group-limited greedy top-k over all of them) and shared experts;
one device's share of the experts, as :func:`hb_cell.arch_of` finds it.

The config's ``n_routed_experts`` counts the experts held here (one
routing group); ``published.n_routed_experts`` is the router's width and
``published.first_expert`` the first held expert.

Weights: a matrix fed by a width n draws N(0, 1/n), the embedding N(0, 1),
norm gains 1 + N(0, 0.1^2), as :mod:`archs.qwen3`, but for the matrices
that end a residual branch (``o_proj``, the dense FFN's and every
expert's down projection), which draw N(0, (RESIDUAL_SCALE)^2 / n).  The
program and the reference get the same tensors: the program as its
parameter containers, the reference as a
:class:`reference.deepseek_v2.Weights` view.

Counts: operations are two a multiply-add; bytes count each input byte
read once and each output byte written once.
"""

from __future__ import annotations

import math
import re

import torch

from hb_weights import buffer
from reference import deepseek_v2 as reference
from reference.deepseek_v2 import Weights

# the MLA kernel's decode launches (``repro_torch.kernels.ops.mla_attention``
# outside a prefill chunk)
DECODE_KERNELS = re.compile(r"\bmla_decode_(partial|combine)_kernel\b")

# the deviation of a residual branch's last matrix, against 1 / sqrt(fan-in)
RESIDUAL_SCALE = 1.0 / 32


def _dims(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def _is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and \
        i % cfg["moe_layer_freq"] == 0


def make_weights(cfg: dict, seed: int, device, dtype) -> Weights:
    """Seeded weights of the configuration ``cfg`` (its published keys) on
    ``device`` in ``dtype``: ``n_routed_experts`` experts a layer behind a
    router of ``published.n_routed_experts`` outputs."""
    d, h, qr, kr, nope, rope, vd = _dims(cfg)
    L, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    e, e_all = cfg["n_routed_experts"], cfg["published"]["n_routed_experts"]
    fs = fe * cfg["n_shared_experts"]
    moe = [_is_moe(cfg, i) for i in range(L)]
    n_moe = sum(moe)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def buf(n, std, mean=0.0):
        return buffer(n, std, gen, device, dtype, mean)

    per_in_d = d * (qr + kr + rope)
    from_d = buf(L * per_in_d + (L - n_moe) * 2 * d * f +
                 n_moe * d * (e_all + 2 * e * fe + 2 * fs) + d * v,
                 1.0 / math.sqrt(d))
    from_q = buf(L * qr * h * (nope + rope), 1.0 / math.sqrt(qr))
    from_kv = buf(L * kr * h * (nope + vd), 1.0 / math.sqrt(kr))
    from_heads = buf(L * h * vd * d, RESIDUAL_SCALE / math.sqrt(h * vd))
    from_ffn = buf((L - n_moe) * f * d, RESIDUAL_SCALE / math.sqrt(f))
    from_expert = buf(n_moe * e * fe * d, RESIDUAL_SCALE / math.sqrt(fe))
    from_shared = buf(n_moe * fs * d, RESIDUAL_SCALE / math.sqrt(fs))
    table = buf(v * d, 1.0)
    gains = buf(L * (2 * d + qr + kr) + d, 0.1, mean=1.0)
    layers = []
    for i in range(L):
        w = {"ln1": gains.take(d), "ln2": gains.take(d),
             "w_dq": from_d.take(d, qr), "q_norm": gains.take(qr),
             "w_uq": from_q.take(qr, h * (nope + rope)),
             "w_dkv": from_d.take(d, kr + rope), "kv_norm": gains.take(kr),
             "w_uk": from_kv.take(kr, h * nope),
             "w_uv": from_kv.take(kr, h * vd),
             "wo": from_heads.take(h * vd, d)}
        if moe[i]:
            w.update(router=from_d.take(d, e_all),
                     experts_gate=from_d.take(e, d, fe),
                     experts_up=from_d.take(e, d, fe),
                     experts_down=from_expert.take(e, fe, d),
                     shared_gate=from_d.take(d, fs),
                     shared_up=from_d.take(d, fs),
                     shared_down=from_shared.take(fs, d))
        else:
            w.update(w_gate=from_d.take(d, f), w_up=from_d.take(d, f),
                     w_down=from_ffn.take(f, d))
        layers.append(w)
    return Weights(embed=table.take(v, d), final_norm=gains.take(d),
                   lm_head=from_d.take(d, v), layers=layers)


def program_params(weights: Weights):
    """The same tensors as the port's ``DecoderParams`` (no copy): the
    dense layers as its head blocks, the expert layers as its blocks."""
    from repro_torch.models.params import (BlockParams, DecoderParams,
                                           FFNParams, MLAParams,
                                           MoEFFNParams)
    head, tail = [], []
    for w in weights.layers:
        attn = MLAParams(**{n: w[n] for n in MLAParams.NAMES})
        if "router" in w:
            ffn = MoEFFNParams(
                router=w["router"], wi_gate=w["experts_gate"],
                wi_up=w["experts_up"], wo=w["experts_down"],
                shared_wi_gate=w["shared_gate"],
                shared_wi_up=w["shared_up"], shared_wo=w["shared_down"])
            tail.append(BlockParams(w["ln1"], w["ln2"], attn, ffn))
        else:
            ffn = FFNParams(w["w_gate"], w["w_up"], w["w_down"])
            head.append(BlockParams(w["ln1"], w["ln2"], attn, ffn))
    return DecoderParams(weights.embed, weights.final_norm,
                         weights.lm_head, tail, head)


def model_config(cfg: dict, dtype: str):
    """The port's ``ModelConfig`` for the published keys of ``cfg``: the
    router over ``published.n_routed_experts``, the experts held from
    ``published.first_expert``, YaRN from ``rope_scaling``, the rope
    dimensions read interleaved as the published code reads them."""
    from repro_torch.models.config import ModelConfig
    rs = cfg["rope_scaling"]
    return ModelConfig(
        name=cfg["name"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg["published"]["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        expert_d_ff=cfg["moe_intermediate_size"],
        first_dense_layers=cfg["first_k_dense_replace"],
        topk_method=cfg["topk_method"], n_group=cfg["n_group"],
        topk_group=cfg["topk_group"], norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        experts_held=cfg["n_routed_experts"],
        first_expert=cfg["published"]["first_expert"],
        use_mla=True, kv_lora_rank=cfg["kv_lora_rank"],
        q_lora_rank=cfg["q_lora_rank"],
        rope_head_dim=cfg["qk_rope_head_dim"],
        nope_head_dim=cfg["qk_nope_head_dim"], v_head_dim=cfg["v_head_dim"],
        yarn_factor=float(rs["factor"]), yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]),
        yarn_original_max_position=rs["original_max_position_embeddings"],
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]), rope_interleaved=True,
        dtype=dtype)


# the published keys that the port's registry config holds, by its names
_PORT_WIDTHS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
    "n_shared_experts": "n_shared_experts",
    "moe_intermediate_size": "expert_d_ff",
    "first_k_dense_replace": "first_dense_layers",
    "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
    "qk_rope_head_dim": "rope_head_dim", "qk_nope_head_dim": "nope_head_dim",
    "v_head_dim": "v_head_dim", "rope_theta": "rope_theta"}


def port_widths(cfg: dict) -> dict:
    """{published key: the port ``ModelConfig``'s field} for every key
    that the port's registry config of ``cfg["name"]`` must equal, leaving
    out the keys that ``cfg["reduced"]`` lists."""
    cut = set(cfg.get("reduced", ()))
    return {k: a for k, a in _PORT_WIDTHS.items() if k not in cut}


def tiny(cfg: dict) -> dict:
    """``cfg`` at a width and depth the CPU serves in seconds: four layers
    (one dense, three expert layers) of width 128, 4 heads, a router of 32
    experts in 8 groups holding one group of 4, the published routing,
    YaRN and head ratios otherwise."""
    return {**cfg, "hidden_size": 128, "intermediate_size": 256,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16,
            "moe_intermediate_size": 32, "n_routed_experts": 4,
            "num_hidden_layers": 4, "vocab_size": 512,
            "published": {**cfg["published"], "n_routed_experts": 32}}


def active_params(cfg: dict) -> float:
    """Matrix parameters a token runs through, summed over the layers
    (norm gains left out): every MLA matrix, the dense FFN, and in an
    expert layer the router, the shared experts and ``top_k`` experts'
    worth of the held experts' share (``top_k`` x held / router width)."""
    d, h, qr, kr, nope, rope, vd = _dims(cfg)
    mla = d * qr + qr * h * (nope + rope) + d * (kr + rope) + \
        kr * h * (nope + vd) + h * vd * d
    e, e_all = cfg["n_routed_experts"], cfg["published"]["n_routed_experts"]
    expert = 3 * d * cfg["moe_intermediate_size"]
    moe = d * e_all + cfg["n_shared_experts"] * expert + \
        cfg["num_experts_per_tok"] * e / e_all * expert
    dense = 3 * d * cfg["intermediate_size"]
    return sum(mla + (moe if _is_moe(cfg, i) else dense)
               for i in range(cfg["num_hidden_layers"]))


def token_flops(cfg: dict, n_tokens: int, attended_keys: int,
                head_rows: int) -> float:
    """Model FLOPs of ``n_tokens`` tokens through every layer in the
    published expanded form (2 an active matrix parameter a token,
    :func:`active_params`), their attention over ``attended_keys`` keys in
    all (summed over tokens, per layer: 2 x H x (nope + rope + v) a key),
    and the output head on ``head_rows`` rows."""
    L = cfg["num_hidden_layers"]
    _, h, _, _, nope, rope, vd = _dims(cfg)
    attn = 2 * h * (nope + rope + vd) * attended_keys
    return 2.0 * active_params(cfg) * n_tokens + attn * L + \
        2.0 * cfg["hidden_size"] * cfg["vocab_size"] * head_rows


def decode_attention_work(cfg: dict, rows: int, keys: int, elt: int):
    """(bytes, operations) of the absorbed-form MLA decode kernel in every
    layer for ``rows`` occupied decode rows (summed over steps) whose
    context lengths, each counting the row's new token, sum to ``keys``;
    ``elt`` bytes an element.  In each layer each row reads its latent
    rows (rank + rope) once for all heads, reads its H absorbed queries
    (rank + rope) and writes H latent outputs (rank); each key costs H x
    (rank + rope + rank) multiply-adds."""
    L = cfg["num_hidden_layers"]
    _, h, _, kr, _, rope, _ = _dims(cfg)
    nbytes = keys * (kr + rope) * elt + rows * h * (2 * kr + rope) * elt
    flops = 2 * h * (2 * kr + rope) * keys
    return L * nbytes, L * flops
