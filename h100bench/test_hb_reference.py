"""The plain reference against the port's plain path at a reduced Qwen3
size on the CPU: the fp32 forward against ``DecoderLM.logits_fn`` on the
same seeded weights; and the greedy gap the check reads."""

import subprocess
import sys

import pytest
import torch

import hb_cell
import hb_check
from reference import qwen3

ARCH = hb_cell.plugin("archs", "qwen3")

CFG = {"name": "qwen3-tiny", "hidden_size": 64, "intermediate_size": 128,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "num_hidden_layers": 3, "vocab_size": 300, "rms_norm_eps": 1e-6,
       "rope_theta": 1000000}


def test_forward_matches_port_plain_path():
    from repro_torch.models import build_model
    w = ARCH.make_weights(CFG, 5, torch.device("cpu"), torch.float32)
    model = build_model(ARCH.model_config(CFG, "float32"))
    params = ARCH.program_params(w)
    toks = torch.randint(0, 300, (2, 40), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        port, _ = model.logits_fn(params, {"tokens": toks})
        ref = qwen3.logits_at(w, CFG, [toks[0], toks[1]],
                              [torch.arange(40), torch.arange(40)])
    for b in range(2):
        torch.testing.assert_close(ref[b], port[b], rtol=2e-4, atol=2e-4)


def test_fp8_control_moves_the_logits():
    w = ARCH.make_weights(CFG, 6, torch.device("cpu"), torch.float32)
    toks = [torch.arange(30) % 300]
    with torch.no_grad():
        a = qwen3.logits_at(w, CFG, toks, [torch.arange(30)])[0]
        b = qwen3.logits_at(w, CFG, toks, [torch.arange(30)], quant="fp8")[0]
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5


def test_weights_repeat_for_a_seed():
    a = ARCH.make_weights(CFG, 2**31 + 3, torch.device("cpu"),
                          torch.bfloat16)
    b = ARCH.make_weights(CFG, 2**31 + 3, torch.device("cpu"),
                          torch.bfloat16)
    assert torch.equal(a.layers[2]["w_down"], b.layers[2]["w_down"])
    assert torch.equal(a.lm_head, b.lm_head)
    assert a.layers[0]["wq"].dtype == torch.bfloat16


def test_gap_is_the_best_logit_less_the_served_one():
    logits = torch.tensor([[0.5, 2.0, -1.0], [3.0, 3.0, 0.0]])
    got = hb_check.gaps(logits, torch.tensor([0, 1]))
    assert got.tolist() == [1.5, 0.0]


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.qwen3; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(qwen3.__file__.rsplit("/reference/", 1)[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    names = eval(out)
    assert "repro_torch" not in names and "repro" not in names
    assert "jax" not in names


@pytest.mark.cuda
def test_forward_matches_on_the_card(cuda_device):
    w = ARCH.make_weights(CFG, 5, cuda_device, torch.bfloat16)
    toks = [torch.arange(64) % 300]
    with torch.no_grad():
        ref = qwen3.logits_at(w, CFG, toks, [torch.arange(64)])[0]
    assert torch.isfinite(ref).all()
