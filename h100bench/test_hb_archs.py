"""An architecture is a plugin (``archs/<model_type>.py``): Qwen3's holds
the weights, counts and reference that were the harness's own, byte for
byte and number for number; a config with no such file is refused; a
stand-in architecture runs the harness from its own files alone; and the
traced slice's decode work is the engine's counters, which equal the
decode calls made inside the slice."""

import hashlib
import json
import shutil
import sys

import pytest
import torch

import hb_cell
import hb_roofline
import hb_trace
from hb_cell import HERE, find_cell, load_json, plugin
from hb_tiny import CELL, tiny_cell, tiny_run
from reference.qwen3 import LAYER_KEYS

ARCH = plugin("archs", "qwen3")

# test_hb_reference.py's tiny Qwen3
CFG = {"name": "qwen3-tiny", "hidden_size": 64, "intermediate_size": 128,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "num_hidden_layers": 3, "vocab_size": 300, "rms_norm_eps": 1e-6,
       "rope_theta": 1000000}

# sha256 of every leaf's bytes (embed, final_norm, lm_head, then each
# layer's LAYER_KEYS in order) as the harness made them before the
# architecture became a plugin
WEIGHT_DIGESTS = [
    (5, torch.float32,
     "01c884c7e343cef98ec0c1b39dc3848edf666039d93dec062afd79df256fca13"),
    (2**31 + 3, torch.bfloat16,
     "25e4a36644fb8aa7411ba8cc891b923304a87d834cba1a678ccdf621bf80b0ac"),
]


def _digest(w) -> str:
    h = hashlib.sha256()
    leaves = [w.embed, w.final_norm, w.lm_head] + \
        [layer[k] for layer in w.layers for k in LAYER_KEYS]
    for t in leaves:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed,dtype,digest", WEIGHT_DIGESTS)
def test_qwen3_weights_are_the_harness_bytes(seed, dtype, digest):
    w = ARCH.make_weights(CFG, seed, torch.device("cpu"), dtype)
    assert _digest(w) == digest


def test_qwen3_counts_at_qwen3_32b():
    """The harness's formulas' numbers at 32 rows attending 20,000 keys: a
    decode step's model FLOPs, and 64 layers of paged calls over 32 rows
    of context 625 (82,968,576 bytes and 655,360,000 operations each)."""
    cfg = load_json(HERE / "configs" / "qwen3-32b.json")
    assert ARCH.token_flops(cfg, 32, 20000, 32) == 2088889221120.0
    assert ARCH.decode_attention_work(cfg, 32, 20000, 2) == \
        (64 * 82968576, 64 * 655360000)
    assert set(ARCH.port_widths(cfg)) == {
        "num_hidden_layers", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size",
        "vocab_size"}
    cut = {**cfg, "reduced": ["num_hidden_layers"]}
    assert "num_hidden_layers" not in ARCH.port_widths(cut)


def test_config_without_architecture_is_refused(tmp_path, monkeypatch):
    root = tmp_path / "h100bench"
    (root / "configs").mkdir(parents=True)
    shutil.copytree(HERE / "mixes", root / "mixes")
    cfg = {**load_json(HERE / "configs" / "qwen3-32b.json"),
           "name": "mystery", "model_type": "mystery_lm"}
    (root / "configs" / "mystery.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(hb_cell, "HERE", root)
    with pytest.raises(FileNotFoundError) as err:
        find_cell("mystery.batch-decode")
    assert str(root / "archs" / "mystery_lm.py") in str(err.value)


# Qwen3 under other names for its widths, with one layer fewer than the
# config's ``n_layer``: the shared harness reads none of these keys.
STANDIN = '''"""A stand-in architecture: Qwen3 with its widths under other names and
one layer fewer than ``n_layer``."""
from types import SimpleNamespace

import hb_cell

Q = hb_cell.plugin("archs", "qwen3")
NAMES = {"hidden_size": "n_embd", "intermediate_size": "n_inner",
         "num_attention_heads": "n_head",
         "num_key_value_heads": "n_kv_head", "head_dim": "d_head"}
DECODE_KERNELS = Q.DECODE_KERNELS


def q(cfg):
    return {**cfg, **{k: cfg[v] for k, v in NAMES.items()},
            "num_hidden_layers": cfg["n_layer"] - 1}


reference = SimpleNamespace(
    logits_at=lambda w, cfg, *a, **k: Q.reference.logits_at(w, q(cfg), *a,
                                                            **k),
    strict_fp32=Q.reference.strict_fp32)
program_params = Q.program_params


def make_weights(cfg, seed, device, dtype):
    return Q.make_weights(q(cfg), seed, device, dtype)


def model_config(cfg, dtype):
    return Q.model_config(q(cfg), dtype)


def token_flops(cfg, n_tokens, attended_keys, head_rows):
    return Q.token_flops(q(cfg), n_tokens, attended_keys, head_rows)


def decode_attention_work(cfg, rows, keys, elt):
    return Q.decode_attention_work(q(cfg), rows, keys, elt)


def tiny(cfg):
    return {**cfg, "n_embd": 128, "n_inner": 384, "n_head": 8,
            "n_kv_head": 2, "d_head": 16, "n_layer": 9, "vocab_size": 512}


def port_widths(cfg):
    return {}
'''


def _standin_tree(tmp_path):
    """A copy of the benchmark's files with a new architecture, its config
    and its cell's limits added, and nothing else changed."""
    root = tmp_path / "h100bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*", "conftest.py"))
    (root / "archs" / "standin.py").write_text(STANDIN)
    cfg = load_json(HERE / "configs" / "qwen3-32b.json")
    names = {"hidden_size": "n_embd", "intermediate_size": "n_inner",
             "num_attention_heads": "n_head",
             "num_key_value_heads": "n_kv_head", "head_dim": "d_head",
             "num_hidden_layers": "n_layer"}
    for k, v in names.items():
        cfg[v] = cfg.pop(k)
    cfg["n_layer"] += 1
    cfg.update(name="standin-32b", model_type="standin")
    (root / "configs" / "standin-32b.json").write_text(json.dumps(cfg))
    (root / "limits" / "standin-32b.batch-decode.json").write_text(
        json.dumps(find_cell(CELL).limits))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_standin_architecture_runs_from_its_files(tmp_path, monkeypatch,
                                                   trace):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(hb_cell, "HERE", _standin_tree(tmp_path))
    cell = tiny_cell("standin-32b.batch-decode")
    assert "hidden_size" not in cell.config
    out = tiny_run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["readings"]["served_tokens"] > 0
    got = out["metrics"]
    if trace:
        assert got["mfu.itl"]["value"] > 0
        assert got["engine.rows_per_decode_step"]["value"] >= 1
    else:
        assert got["output_tok_s"]["value"] > 0
        assert got["itl_p95_ms"]["value"] > 0


def test_slice_counters_are_the_decode_calls(monkeypatch):
    """The slice's ``decode_rows`` / ``decode_kv_tokens`` differences are
    the occupied rows and their context lengths summed over the engine's
    decode calls whose counts fell inside the slice; both readers read
    them."""
    from repro_torch.serving import engine
    calls = []
    orig = engine._ShardEngine._paged_decode_step

    def counted(self, block_tables, ctx_lens, tokens, occ, *rest):
        o = occ.cpu()
        calls.append((self.decode_rows, int(o.sum()),
                      int(ctx_lens.cpu()[o].sum())))
        return orig(self, block_tables, ctx_lens, tokens, occ, *rest)

    monkeypatch.setattr(engine._ShardEngine, "_paged_decode_step", counted)
    cell = tiny_cell()
    out = tiny_run(cell, trace=True)
    assert out["correct"], out["checks"]
    run, sl, cfg = out["run"], out["run"].slice, cell.config
    lo, hi = sl.stats_a["decode_rows"], sl.stats_b["decode_rows"]
    inside = [c for c in calls if lo < c[0] <= hi]
    assert inside
    rows = sum(n for _, n, _ in inside)
    keys = sum(k for _, _, k in inside)
    assert hb_trace.slice_decode_work(sl) == (rows, keys)

    peak = hb_roofline.PEAK_FLOPS[cfg["torch_dtype"]]
    mfu = plugin("metrics", "mfu.itl").read(run)
    assert mfu == pytest.approx(
        100.0 * ARCH.token_flops(cfg, rows, keys, rows) / (sl.window_s * peak))
    # the CPU trace has no device kernels: give the slice one decode
    # kernel's device time
    sl.kernels = [("paged_mma::paged_mma_kernel<128>", 2e-3),
                  ("nvjet_tst_128x32_64x10_4x1_v_bz_NNT", 5e-3)]
    ms, _ = hb_roofline.bound(*ARCH.decode_attention_work(cfg, rows, keys, 4),
                              cfg["torch_dtype"])
    roof = plugin("metrics", "paged_attention.roofline").read(run)
    assert roof == pytest.approx(100.0 * ms / 1e3 / 2e-3)
    assert roof > 0
