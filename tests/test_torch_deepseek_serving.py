"""DeepSeek-V2 served through ``repro_torch.serving`` on the CPU, held
against the benchmark's plain fp32 reference (``h100bench/reference/
deepseek_v2.py``, which imports nothing of the port): the served logits of
every emitted token (packed prefill chunks that cut prompts mid-way, decode
steps through the latent pool, decode riders, padded rows) equal the
reference's full forward at a tiny size; the group-limited greedy routing
equals a literal transcription of the published rule; YaRN's frequencies
and scale equal hand-computed values at the published settings; the held
shares of all eight routing groups, with the shared experts once, add up
to the uncut expert layer; and a latent pool refuses speculative decoding,
the swap tier and live migration, as the engine refuses a family it does
not serve."""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.config import options
from repro_torch.models.layers import yarn_correction_range, yarn_inv_freq
from repro_torch.models.mla import softmax_scale
from repro_torch.models.moe import dropless_moe, route_dropless
from repro_torch.models.params import MoEFFNParams
from repro_torch.serving import engine as eng

BENCH = Path(__file__).resolve().parents[1] / "h100bench"

# The served logits against the reference's: in fp32 they differ only by
# the order of sums (absorbed against expanded attention, the latent pool,
# the grouped expert sums), under 1e-4 at this size; bf16 weights move them
# by 1e-2 and more.
LOGIT_TOL = 2e-3


def _load(name, rel):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def arch():
    return _load("deepseek_v2_arch_for_tests", "archs/deepseek_v2.py")


@pytest.fixture(scope="module")
def tiny_cfg(arch):
    import json
    cfg = json.loads((BENCH / "configs" / "deepseek-v2-236b.json")
                     .read_text())
    return arch.tiny(cfg)


def _serve_and_record(arch, cfg, weights, prompts, max_new, monkeypatch):
    """Serve ``prompts`` (all submitted at once, 4 rows, 32-lane packed
    chunks) and record every sampled row's logits by (request id,
    position sampled at)."""
    rec, last = {}, {}
    orig_ops, orig_sample = eng._ShardEngine._operands, \
        eng._ShardEngine._sample

    def operands(seqs, n):
        last["seqs"] = list(seqs)
        return orig_ops(seqs, n)

    def sample(self, logits, sampf, sampi, spos):
        for i, seq in enumerate(last["seqs"]):
            rec[(seq.req.req_id, int(spos[i]))] = logits[i].float().clone()
        return orig_sample(self, logits, sampf, sampi, spos)

    monkeypatch.setattr(eng._ShardEngine, "_operands",
                        staticmethod(operands))
    monkeypatch.setattr(eng._ShardEngine, "_sample", sample)
    model = build_model(arch.model_config(cfg, "float32"))
    sc = serving.ServingConfig(num_pages=128, page_size=8, max_batch=4,
                               max_seq_len=96, scheduler="packed",
                               prefill_chunk_tokens=32, watchdog="off")
    session = serving.serve(model, arch.program_params(weights), sc,
                            device="cpu")
    with session:
        handles = [session.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, max_new)]
        for h in handles:
            h.result()
    shard = session.engine.shards[0]
    return rec, handles, shard, session.stats()["totals"]


def _served_gap(arch, cfg, weights, ref_weights, monkeypatch):
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(0, cfg["vocab_size"], size=n))
               for n in (21, 45, 13, 38, 29, 17)]
    max_new = [9, 6, 12, 5, 8, 10]
    rec, handles, shard, totals = _serve_and_record(
        arch, cfg, weights, prompts, max_new, monkeypatch)
    worst, n = 0.0, 0
    for p, h in zip(prompts, handles):
        req = h.req
        seq = torch.tensor(list(p) + req.out_tokens[:-1])
        pos = torch.arange(len(p) - 1, len(p) - 1 + len(req.out_tokens))
        ref = arch.reference.logits_at(ref_weights, cfg, [seq], [pos])[0]
        for j, at in enumerate(pos.tolist()):
            got = rec[(req.req_id, at + 1)]
            worst = max(worst, float((got - ref[j]).abs().max()))
            n += 1
    return worst, n, shard, totals


def _weights(arch, cfg, seed=7):
    return arch.make_weights(cfg, seed, torch.device("cpu"), torch.float32)


def test_served_logits_match_the_reference(arch, tiny_cfg, monkeypatch):
    w = _weights(arch, tiny_cfg)
    worst, n, shard, totals = _served_gap(arch, tiny_cfg, w, w, monkeypatch)
    assert n == 50
    assert worst < LOGIT_TOL
    # packed chunks cut prompts mid-way, decode steps carried riders
    assert totals["packed_chunks"] > 0 and totals["rider_chunks"] > 0
    assert totals["mla_prefill_rows"] == sum((21, 45, 13, 38, 29, 17))
    assert totals["moe_decode_passes"] > 0
    # a decode step of padded rows only (page -1) writes nothing
    before = shard.stack.latent_pages.clone()
    b = shard.max_batch
    with torch.inference_mode():
        shard._decode_logits([])
    assert torch.equal(shard.stack.latent_pages, before)
    assert b == 4 and totals["decode_rows"] > 0


def test_bf16_weights_fail_the_same_comparison(arch, tiny_cfg, monkeypatch):
    w = _weights(arch, tiny_cfg)
    rounded = arch.reference.Weights(
        embed=w.embed.bfloat16().float(),
        final_norm=w.final_norm.bfloat16().float(),
        lm_head=w.lm_head.bfloat16().float(),
        layers=[{k: t.bfloat16().float() for k, t in layer.items()}
                for layer in w.layers])
    worst, _, _, _ = _served_gap(arch, tiny_cfg, rounded, w, monkeypatch)
    assert worst > LOGIT_TOL


def _published_gate(scores, n_group, topk_group, top_k, scaling):
    """DeepSeek-V2's ``MoEGate.forward`` for ``topk_method``
    "group_limited_greedy", ``norm_topk_prob`` false, as published."""
    n = scores.shape[0]
    group_scores = scores.view(n, n_group, -1).max(dim=-1).values
    group_idx = torch.topk(group_scores, k=topk_group, dim=-1,
                           sorted=False)[1]
    group_mask = torch.zeros_like(group_scores)
    group_mask.scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(
        n, n_group, scores.shape[1] // n_group).reshape(n, -1)
    tmp_scores = scores.masked_fill(~score_mask.bool(), 0.0)
    topk_weight, topk_idx = torch.topk(tmp_scores, k=top_k, dim=-1,
                                       sorted=False)
    return topk_weight * scaling, topk_idx


def test_group_limited_greedy_is_the_published_rule():
    cfg = options(get_config("deepseek-v2-236b")).replace(
        topk_method="group_limited_greedy", n_group=8, topk_group=3,
        norm_topk_prob=False, routed_scaling_factor=16.0)
    logits = torch.randn((500, 160), generator=torch.Generator()
                         .manual_seed(3))
    w, e = route_dropless(torch.eye(160), cfg, logits)
    pw, pe = _published_gate(torch.softmax(logits, dim=-1), 8, 3, 6, 16.0)
    order, porder = torch.argsort(e, dim=-1), torch.argsort(pe, dim=-1)
    assert torch.equal(e.gather(1, order), pe.gather(1, porder))
    torch.testing.assert_close(w.gather(1, order), pw.gather(1, porder),
                               rtol=0, atol=0)
    # every chosen expert lies in one of the three kept groups
    assert all(len(set(row)) <= 3 for row in (e // 20).tolist())


def test_yarn_at_the_published_settings():
    """factor 40, mscale = mscale_all_dim = 0.707, original context 4096,
    beta 32 / 1, rope dim 64, base 10000: pairs 10 and below keep their
    frequency, 23 and above are divided by 40, a linear ramp between; the
    score scale is 192^-1/2 (1 + 0.0707 ln 40)^2."""
    assert yarn_correction_range(32, 1, 64, 10000.0, 4096) == (10, 23)
    inv = yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0).double()
    base = 1.0 / 10000.0 ** (torch.arange(32, dtype=torch.float64) / 32)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = base * (1 - ramp) + base / 40 * ramp
    torch.testing.assert_close(inv, want, rtol=1e-6, atol=0)
    assert inv[10] == pytest.approx(base[10].item(), rel=1e-6)
    assert inv[23] == pytest.approx(base[23].item() / 40, rel=1e-6)
    cfg = options(get_config("deepseek-v2-236b")).replace(
        yarn_factor=40.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)
    m = 1 + 0.1 * 0.707 * math.log(40)
    assert m == pytest.approx(1.26081, abs=1e-5)
    assert softmax_scale(cfg) == pytest.approx(m * m / math.sqrt(192),
                                               rel=1e-12)
    assert softmax_scale(cfg) == pytest.approx(0.11472, abs=1e-5)
    assert softmax_scale(get_config("deepseek-v2-236b")) == \
        1 / math.sqrt(192)


def test_group_shares_add_up_to_the_uncut_layer(arch, tiny_cfg):
    """The routed parts of all eight groups' held experts, each computed as
    one device of the deployment computes it, plus the shared experts once,
    equal the reference's expert layer holding all 32 experts."""
    cfg = tiny_cfg
    e_all, held = cfg["published"]["n_routed_experts"], \
        cfg["n_routed_experts"]
    uncut = {**cfg, "n_routed_experts": e_all,
             "published": {**cfg["published"], "first_expert": 0}}
    w = _weights(arch, uncut).layers[1]
    x = torch.randn((40, cfg["hidden_size"]),
                    generator=torch.Generator().manual_seed(1))
    want = arch.reference.experts(x, w, uncut, None)
    total = torch.zeros_like(x)
    for g in range(e_all // held):
        part = cfg | {"published": {**cfg["published"],
                                    "first_expert": g * held}}
        mcfg = arch.model_config(part, "float32")
        sl = slice(g * held, (g + 1) * held)
        p = MoEFFNParams(router=w["router"], wi_gate=w["experts_gate"][sl],
                         wi_up=w["experts_up"][sl],
                         wo=w["experts_down"][sl])
        total += dropless_moe(p, mcfg, x)
    shared = MoEFFNParams(router=w["router"], wi_gate=w["experts_gate"][:0],
                          wi_up=w["experts_up"][:0],
                          wo=w["experts_down"][:0],
                          shared_wi_gate=w["shared_gate"],
                          shared_wi_up=w["shared_up"],
                          shared_wo=w["shared_down"])
    total += dropless_moe(shared, arch.model_config(cfg, "float32"), x)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,what", [
    ({"spec_k": 2}, "speculative decoding"),
    ({"swap_bytes": 1 << 20, "eviction": "swap"}, "swap tier"),
    ({"watchdog": "migrate"}, "live migration"),
    (None, "serves dense and MLA models"),
])
def test_latent_pool_refuses(arch, tiny_cfg, kw, what):
    if kw is None:
        # a family the engine does not serve at all
        cfg = get_config("mamba2-1.3b").reduced().replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu")
    else:
        cfg = arch.model_config(tiny_cfg, "float32")
        model = build_model(cfg)
        params = arch.program_params(_weights(arch, tiny_cfg))
    sc = serving.ServingConfig(**{"num_pages": 64, "page_size": 8,
                                  "max_batch": 2, "max_seq_len": 64,
                                  "watchdog": "off", **(kw or {})})
    with pytest.raises(ValueError, match=what) as err:
        serving.serve(model, params, sc, device="cpu")
    assert ("mamba2-1.3b" if kw is None else "deepseek-v2-236b") in \
        str(err.value)
