"""The torch port's launchers against the JAX package's.

* The dry run on the ``fake`` process group, world 8, on (2,4) and
  (2,2,2) meshes shrunk as ``tests/test_distributed.py`` shrinks the
  reference's, with that test's assertions (in a subprocess of its own:
  the fake group is process-wide).
* ``collective_bytes_from_ops`` with the numbers of
  ``test_collective_parser``.
* The roofline's math with the H100 constants, and ``count_params``
  equal to JAX's ``(N_total, N_active)`` for all ten archs, exactly.
* ``launch.serve.main`` on the CPU: 4 completed, 0 failed, the
  reference's line format."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["tinyllama-1.1b", "qwen3-8b", "qwen3-32b", "llama3-405b",
         "olmoe-1b-7b", "deepseek-v2-236b", "qwen2-vl-72b", "mamba2-1.3b",
         "zamba2-1.2b", "whisper-base"]


def test_dryrun_cell_small_fake_mesh():
    """dryrun_cell end to end on the fake group at world 8: the step on
    meta DTensors, the local tally, the collectives, the memory record."""
    script = textwrap.dedent("""
        import json
        import repro_torch.launch.dryrun as dr
        import repro_torch.configs.base as base
        # the production mesh shrunk to the 8 ranks of the fake group
        dr.production_shape = lambda multi_pod=False: (
            ((2, 2, 2), ("pod", "data", "model")) if multi_pod
            else ((2, 4), ("data", "model")))
        base.SHAPES["train_4k"] = base.ShapeSpec("train_4k", 64, 8, "train")
        over = {"n_layers": 2, "d_model": 64, "n_heads": 4,
                "n_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                "vocab_size": 256}
        rec = dr.dryrun_cell("tinyllama-1.1b", "train_4k", overrides=over,
                             verbose=False)
        assert rec["flops_per_device"] > 0
        assert rec["bytes_accessed_per_device"] > 0
        assert rec["n_chips"] == 8
        assert rec["mesh"] == {"data": 2, "model": 4}
        assert rec["collectives"]["all-gather"]["count"] > 0
        assert rec["bytes_basis"] == "unfused aten ops"
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["memory"]["peak_bytes"] is None
        print("DRYRUN_OK", json.dumps(
            {k: rec[k] for k in ("flops_per_device", "n_chips")}))
        rec2 = dr.dryrun_cell("tinyllama-1.1b", "train_4k", multi_pod=True,
                              overrides=over, verbose=False)
        assert rec2["n_chips"] == 8 and rec2["mesh"]["pod"] == 2
        # fewer devices per pod's worth of batch: less local work
        assert 0 < rec2["flops_per_device"] <= rec["flops_per_device"] * 2
        print("MULTIPOD_OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    assert "DRYRUN_OK" in out.stdout and "MULTIPOD_OK" in out.stdout


def test_collective_tally():
    from repro_torch.launch.dryrun import collective_bytes_from_ops
    ops = [("_c10d_functional.all_reduce", 128 * 256 * 4),
           ("_c10d_functional.all_gather_into_tensor", 64 * 2),
           ("c10d.send", 16 * 16 * 4),
           ("aten.add", 2 * 4),
           ("_c10d_functional.all_reduce_", 8 * 4),
           ("_c10d_functional.wait_tensor", 8 * 4)]
    out = collective_bytes_from_ops(ops)
    assert out["all-reduce"]["bytes"] == 128 * 256 * 4 + 8 * 4
    assert out["all-reduce"]["count"] == 2
    assert out["all-gather"]["bytes"] == 64 * 2
    assert out["collective-permute"]["bytes"] == 16 * 16 * 4
    assert out["all-to-all"]["count"] == 0
    assert out["reduce-scatter"] == {"bytes": 0, "count": 0}


def test_roofline_math():
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                             analyze_record)
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    rec = {
        "arch": "tinyllama-1.1b", "shape": "train_4k", "kind": "train",
        "multi_pod": False, "n_chips": 256,
        "flops_per_device": PEAK_FLOPS,            # exactly 1 second
        "bytes_accessed_per_device": HBM_BW / 2,   # 0.5 s
        "collective_bytes_per_device": LINK_BW / 4,  # 0.25 s
        "collectives": {},
    }
    a = analyze_record(rec, SHAPES)
    assert abs(a["t_compute_s"] - 1.0) < 1e-9
    assert abs(a["t_memory_s"] - 0.5) < 1e-9
    assert abs(a["t_collective_s"] - 0.25) < 1e-9
    assert a["dominant"] == "compute"
    assert 0 < a["model_over_counted"] < 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax(arch):
    from repro.launch.roofline import count_params as jax_count
    from repro_torch.launch.roofline import count_params
    assert count_params(arch)[:2] == jax_count(arch)[:2]


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--requests", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"\[serve\] tinyllama-1\.1b-reduced smr=IBR "
                        r"shards=1: \{.*\}", line), line
    assert out["totals"]["completed"] == 4
    assert out["totals"]["failed"] == 0
    assert [len(t) for t in out["tokens"]] == [8] * 4
