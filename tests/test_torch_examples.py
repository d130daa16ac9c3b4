"""The torch port's examples (``examples/torch_*.py``) against the JAX
package's, on the CPU at the reduced config.

* ``torch_quickstart.py``: its deterministic demos (the SCOT list and
  NM-tree snapshots with their stats, capability negotiation, the
  wait-free traversal under a stalled writer, the serving surface, the
  stalled-thread garbage of EBR and IBR) print what ``quickstart.py``'s
  print, but for the serving demo's pointer to its own example and the
  ``backend`` entry of the reference's config summary.  The Figure-1
  race, which may not fire, is left out.
* ``torch_serve_paged.py`` on ``--device cpu`` with the bridged weights
  (the JAX init at ``PRNGKey(7)`` through ``from_jax_params``): a small
  mix (2 shards, 6 requests, 2 clients, 1 long prompt, 4 new tokens)
  through the port's session and, with the same workload arguments,
  through the JAX session under the reference's
  ``run_serving_workload``.  Every prompt gets identical greedy tokens
  (fp32, exact), every request completes, none fails, and no page
  outlives either session.
* ``torch_train_lm.py`` for a few steps into ``tmp_path``; ``--resume``
  then starts from the step the first run saved.
* Both device-bound examples default to the card: with no card they
  raise instead of running on the CPU."""

import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.core.workload import run_serving_workload as jrun_workload
from repro.models import build_model as jbuild_model
from repro_torch import serving
from repro_torch.models import from_jax_params

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name, as_name):
    spec = importlib.util.spec_from_file_location(as_name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstarts():
    return (_load("quickstart", "reference_quickstart"),
            _load("torch_quickstart", "torch_quickstart"))


@pytest.mark.parametrize("demo", ["demo_scot_traversals", "demo_negotiation",
                                  "demo_waitfree", "demo_serving_surface",
                                  "demo_nm_tree", "demo_robustness"])
def test_quickstart_demo_prints_the_reference_lines(quickstarts, demo,
                                                    capsys):
    ref, port = quickstarts
    getattr(ref, demo)()
    want = capsys.readouterr().out
    getattr(port, demo)()
    got = capsys.readouterr().out
    # the serving demo names each package's own serving example, and the
    # reference's config summary the backend, a field the port has not
    assert got == want.replace(
        "examples/serve_paged.py", "examples/torch_serve_paged.py").replace(
        "'backend': 'xla', ", "")
    assert got.strip()


SMALL_MIX = ["--device", "cpu", "--requests", "6", "--clients", "2",
             "--long-prompts", "1", "--max-new", "4"]


def _jax_config(args):
    """The reference example's ``ServingConfig`` for ``args``."""
    return jserving.ServingConfig(
        smr=args.smr, num_shards=args.shards, shard_smr=args.shard_smr,
        num_pages=128, page_size=8, max_batch=4, max_seq_len=256,
        admission=args.admission, eviction=args.eviction,
        scheduler=args.scheduler, backend="xla",
        prefill_chunk_tokens=args.chunk_tokens,
        prefix_traversal=args.prefix_traversal, watchdog=args.watchdog,
        default_timeout_s=args.timeout_s, faults=tuple(args.fault) or None,
        swap_bytes=args.swap_bytes,
        priority_classes=tuple(args.priority_class) or None)


def _drive(ex, session, run, args):
    """(result, {prompt: tokens}, shards) of one run, the session closed."""
    rec = ex.Recorder(session)
    with session:
        res = run(rec, args)
        shards = session.engine.shards
    streams = rec.streams()
    prompts = [tuple(p) for p, _ in streams]
    assert len(set(prompts)) == len(prompts), "the mix repeats a prompt"
    return res, {tuple(p): t for p, t in streams}, shards


def test_serving_example_matches_the_jax_session_under_its_workload():
    ex = _load("torch_serve_paged", "torch_serve_paged")
    args = ex.parse(SMALL_MIX)
    cfg, model, _, config = ex.build(args)
    assert cfg.name == "tinyllama-1.1b-reduced" and cfg.dtype == "float32"
    jcfg = jget_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")

    res, got, shards = _drive(
        ex, serving.serve(model, tp, config, device="cpu", start=False),
        ex.run, args)
    jres, want, jshards = _drive(
        ex, jserving.serve(jmodel, jp, _jax_config(args), start=False),
        lambda s, a: jrun_workload(s, **ex.workload(a)), args)

    assert len(got) == 7 and got.keys() == want.keys()
    assert max(len(p) for p in got) == 192        # the long prompt
    assert got == want
    assert all(len(t) == 4 for t in got.values())
    for r in (res, jres):
        assert r.requests == 7 and r.failed == 0 and r.incomplete == 0
        assert r.session_stats["totals"]["completed"] == 7
    for s in list(shards) + list(jshards):
        assert s.pool.free_count() == s.config.num_pages


def test_serving_example_main_prints_the_reference_lines(capsys):
    ex = _load("torch_serve_paged", "torch_serve_paged")
    out = ex.main(SMALL_MIX)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(
        r"scheme=IBR shards=2 admission=fifo eviction=fifo "
        r"scheduler=chunked/16tok device=cpu requests=7 generated=28 "
        r"tokens in .*s \(.* tok/s, prefix hits=\d+, ttft_p99=.*ms, "
        r"itl_p99=.*ms\)", lines[0]), lines[0]
    assert lines[1].startswith("totals: {")
    assert [ln.split(":")[0] for ln in lines[2:]] == ["  shard 0",
                                                      "  shard 1"]
    assert out["stats"]["totals"]["completed"] == 7
    assert out["stats"]["totals"]["failed"] == 0
    assert [len(t) for _, t in out["streams"]] == [4] * 7


def test_training_example_resumes_from_its_saved_step(tmp_path, capsys):
    ex = _load("torch_train_lm", "torch_train_lm")
    argv = ["--device", "cpu", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]
    first = ex.main(argv + ["--steps", "3"])
    assert (first["start"], first["step"]) == (0, 3)
    assert len(first["losses"]) == 3
    assert all(np.isfinite(first["losses"]))
    capsys.readouterr()
    second = ex.main(argv + ["--steps", "2", "--resume"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("training tinyllama-1.1b-reduced from step 3 for "
                        "2 steps …")
    assert (second["start"], second["step"]) == (3, 5)
    assert lines[-1].startswith("final loss ")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3",
                                                          "step_5"]


@pytest.mark.parametrize("name", ["torch_serve_paged", "torch_train_lm"])
def test_examples_default_to_the_card(name, monkeypatch):
    ex = _load(name, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main([])
