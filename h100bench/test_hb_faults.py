"""A whole run on the CPU (the chip's look skipped) through the harness,
judged by the committed cell's own limits (``limits/<cell>.json``): it
comes out correct on the sound program, and not correct with the served
path broken underneath (:mod:`hb_faults`): a token altered where it is
picked, a decode step that leaves the KV pages as they were, half of the
decode batch left out.  The fp8 control reads far above the sound
program.  The cell is the real mix at a size the CPU serves in seconds;
it has one chip, so there is no exchange between chips to leave out."""

import json
import subprocess
import sys

import hb_check
import hb_faults
from hb_cell import HERE, find_cell
from hb_tiny import CELL, tiny_cell, tiny_run


def test_tiny_cell_keeps_the_committed_limits():
    assert tiny_cell().limits == find_cell(CELL).limits
    assert tiny_cell().limits["greedy_gap"] > 0


# The tiny cell's own limit for the fp8 control: served in fp32 on the
# CPU, the program reads 0.0 against the fp32 reference; the control reads
# 0.19-0.49 here (its error grows with depth and with the positions read),
# about the cell's limit, and 0.7466 and more at the cell's size on the
# card.
TINY_FP32_LIMITS = {"greedy_gap": 1e-3}


def test_sound_run_is_correct_and_control_is_not():
    out = tiny_run(tiny_cell(), control=True)
    assert out["correct"], out["checks"]
    assert out["readings"]["served_tokens"] > 0
    ok, _ = hb_check.judge(out["readings"], 0, TINY_FP32_LIMITS)
    assert ok, out["readings"]
    ok, checks = hb_check.judge(out["readings"], 0, TINY_FP32_LIMITS,
                                control=True)
    assert not ok, checks
    assert out["readings"]["control_greedy_gap"] > \
        3 * max(out["readings"]["greedy_gap"], 1e-4)


def test_altered_token_is_caught(monkeypatch):
    hb_faults.plant("altered_token", monkeypatch.setattr)
    out = tiny_run(tiny_cell())
    assert not out["correct"], out["checks"]


def test_step_leaving_pages_unchanged_is_caught(monkeypatch):
    hb_faults.plant("pages_unchanged", monkeypatch.setattr)
    out = tiny_run(tiny_cell())
    assert not out["correct"], out["checks"]


def test_half_batch_left_out_is_caught(monkeypatch):
    hb_faults.plant("half_batch", monkeypatch.setattr)
    out = tiny_run(tiny_cell())
    assert not out["correct"], out["checks"]


def test_traced_run_reads_per_layer_metrics():
    out = tiny_run(tiny_cell(), trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["engine.rows_per_decode_step"]["value"] >= 1
    assert got["mfu.itl"]["value"] > 0
    assert "window_s" in out["device"]


def test_run_loads_no_jax():
    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "from hb_tiny import tiny_cell, tiny_run\n"
        "import run\n"
        "tiny_run(tiny_cell(), seconds=0.8)\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % (str(HERE), str(HERE.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    assert json.loads(out[-2]) == []
    names = set(json.loads(out[-1]))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_no_program_no_result(tmp_path):
    """A directory holding only the benchmark's files gives no result."""
    import shutil
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
