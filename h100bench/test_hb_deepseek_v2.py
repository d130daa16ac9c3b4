"""DeepSeek-V2's cell: its config the published one but for the two keys
it lists as reduced, its weights and counts at the published widths
(41.6 GB of weights on the card, 34,560 B of latent a token), a weight
digest at one seed, the cell served and checked at a tiny width on the
CPU, and its three readers silent on a run without what they read."""

import hashlib
from types import SimpleNamespace

import pytest
import torch

from hb_cell import HERE, find_cell, load_json, plugin
from hb_weights import Carver

CELL = "deepseek-v2-236b.batch-gen-256"
READERS = ("mla_decode.roofline", "mfu.moe_itl", "moe.rows_per_expert")

ARCH = plugin("archs", "deepseek_v2")
CFG = load_json(HERE / "configs" / "deepseek-v2-236b.json")


def test_the_config_is_the_published_one_but_the_cut():
    """Every width as published; the two cut keys with their published
    values beside them; the port's registry config equals the file on
    every width the architecture names."""
    from repro_torch.configs import get_config
    assert CFG["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert (CFG["num_hidden_layers"], CFG["n_routed_experts"]) == (30, 20)
    pub = CFG["published"]
    assert (pub["num_hidden_layers"], pub["n_routed_experts"]) == (60, 160)
    assert pub["first_expert"] == pub["held_group"] * CFG["n_routed_experts"]
    assert pub["n_routed_experts"] // CFG["n_group"] == \
        CFG["n_routed_experts"]
    assert CFG["rope_scaling"] == {
        "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}
    widths = ARCH.port_widths(CFG)
    port = get_config(CFG["name"])
    assert {k: getattr(port, a) for k, a in widths.items()} == \
        {k: CFG[k] for k in widths}
    mc = ARCH.model_config(CFG, "bfloat16")
    assert (mc.n_experts, mc.experts_held, mc.first_expert, mc.n_layers) == \
        (160, 20, 0, 30)
    eng = CFG["engine"]
    assert eng["num_pages"] >= eng["max_batch"] * eng["max_seq_len"] // \
        eng["page_size"]


def test_weights_and_counts_at_the_published_widths(monkeypatch):
    """41.6 GB of bf16 weights (30 layers, 20 experts each); 34,560 B of
    latent a token; a decode step's model FLOPs and the MLA kernel's
    bytes and operations at 256 rows of context 1,150."""
    made = []

    def meta_buffer(n, std, gen, device, dtype, mean=0.0):
        made.append(Carver(torch.empty(n, dtype=dtype, device="meta")))
        return made[-1]
    monkeypatch.setattr(ARCH, "buffer", meta_buffer)
    w = ARCH.make_weights(CFG, 1, torch.device("cpu"), torch.bfloat16)
    assert all(c.at == c.buf.numel() for c in made)
    leaves = [w.embed, w.final_norm, w.lm_head] + \
        [t for layer in w.layers for t in layer.values()]
    nbytes = sum(t.numel() for t in leaves) * 2
    assert nbytes == 41_581_045_760
    assert w.layers[1]["router"].shape == (5120, 160)
    assert w.layers[1]["experts_gate"].shape == (20, 5120, 1536)
    d, _, _, kr, _, rope, _ = ARCH._dims(CFG)
    assert CFG["num_hidden_layers"] * (kr + rope) * 2 == 34_560
    # 2 x 6,570,803,200 active parameters a token, 2 x 128 x 320 a key a
    # layer, the head on 256 rows
    assert ARCH.active_params(CFG) == 6_570_803_200
    assert ARCH.token_flops(CFG, 256, 256 * 1150, 256) == \
        4_356_204_134_400.0
    # a layer: 294,400 keys x 576 x 2 B + 256 x 128 x 1,088 x 2 B, and
    # 294,400 x 128 x 1,088 x 2 operations
    assert ARCH.decode_attention_work(CFG, 256, 256 * 1150, 2) == \
        (30 * 410_451_968, 30 * 81_998_643_200)


def _digest(w) -> str:
    h = hashlib.sha256()
    leaves = [w.embed, w.final_norm, w.lm_head] + \
        [layer[k] for layer in w.layers
         for k in ARCH.reference.layer_keys(layer)]
    for t in leaves:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_weight_digest_at_one_seed():
    w = ARCH.make_weights(ARCH.tiny(CFG), 2**31 + 5, torch.device("cpu"),
                          torch.float32)
    assert _digest(w) == (
        "2044cd9090f43fc29a974c0a04f630dff98ced20f780256d8935fd77bdb7ad12")


def test_tiny_cell_serves_and_checks_on_the_cpu():
    """The cell's files at the architecture's tiny widths, served through
    the harness on the CPU in fp32 and traced: correct under the cell's
    own limit, nothing failed, and the expert-layer reader reads the
    pairs each held expert saw."""
    import hb_tiny
    out = hb_tiny.tiny_run(hb_tiny.tiny_cell(CELL), trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["readings"]["requests"] >= 1
    assert out["readings"]["greedy_gap"] <= \
        find_cell(CELL).limits["greedy_gap"]
    rows = out["metrics"]["moe.rows_per_expert"]["value"]
    assert 0 < rows <= 4 * 6 / 4


# a run of a program without the MLA kernel, the expert counters or a
# traced slice (the parent's, say); a dense model's run, its expert
# counters at zero
RUNS = {"no_counters": (CELL, None, {"decode_rows": 10}),
        "dense_model": ("qwen3-32b.batch-decode", object(),
                        {"decode_rows": 10, "decode_kv_tokens": 100,
                         "moe_decode_passes": 0,
                         "moe_decode_local_pairs": 0})}


@pytest.mark.parametrize("case", sorted(RUNS))
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_its_counters(name, case):
    """Each new metric is left out of such a run's line."""
    workload, slice_, stats = RUNS[case]
    run = SimpleNamespace(cell=find_cell(workload), slice=slice_,
                          stats_a={}, stats_b=stats)
    assert plugin("metrics", name).read(run) is None
