"""The torch port's training substrate on the CPU: the counterparts of the
single-device tests of ``tests/test_train_substrate.py`` (loss falls,
checkpoint restart replays, failures are retried, microbatches accumulate,
the data pipeline seeks, the heartbeat registry survives churn, the
straggler watchdog flags), then the port's ``Trainer`` held against the
JAX ``Trainer`` from the same bridged init, a byte-exact bf16 checkpoint
round trip, and the launcher.  Limits are the JAX tests' own: replayed
losses within rtol = atol = 2e-4, losses against the JAX trainer within
2e-4 and parameters after 5 steps within 2e-3 (fp32: the frameworks sum
in different orders, and five AdamW steps carry the difference into the
parameters)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.train.loop import Trainer as JTrainer
from repro_torch.checkpoint.manager import flatten_tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import from_jax_params
from repro_torch.models.params import flatten_params
from repro_torch.train.fault_tolerance import HeartbeatRegistry, \
    StragglerWatchdog, TransientFailure
from repro_torch.train.loop import Trainer, TrainState


def _tiny_cfg(cfg_fn=get_config, arch="tinyllama-1.1b"):
    return cfg_fn(arch).reduced().replace(
        dtype="float32", vocab_size=64, remat="none")


def _trainer(**kw):
    return Trainer(_tiny_cfg(), device="cpu", **kw)


def test_loss_decreases():
    tr = _trainer(global_batch=8, seq_len=32, lr=3e-3, total_steps=60)
    state = tr.train(tr.init_state(), 60)
    tr.close()
    first = np.mean(tr.losses[:5])
    last = np.mean(tr.losses[-5:])
    assert last < first - 0.2, (first, last)
    assert state.step == 60


def test_checkpoint_restart_resumes_exactly(tmp_path):
    # run 1: 30 steps with checkpoints every 10
    tr1 = _trainer(global_batch=4, seq_len=32,
                   checkpoint_dir=tmp_path / "ck", checkpoint_every=10)
    tr1.train(tr1.init_state(), 30)
    tr1.close()
    losses_tail = tr1.losses[20:30]
    assert sorted(tr1.ckpt.all_steps()) == [10, 20, 30]

    # run 2: crash-restart from step 20 and replay 20..30
    tr2 = _trainer(global_batch=4, seq_len=32,
                   checkpoint_dir=tmp_path / "ck", checkpoint_every=10)
    st = tr2.restore(20)
    assert st.step == 20
    st = tr2.train(st, 10)
    tr2.close()
    np.testing.assert_allclose(tr2.losses, losses_tail, rtol=2e-4, atol=2e-4)
    assert st.step == 30


def test_failure_injection_retry():
    boom = {20: 2}  # fail step 20 twice

    def hook(step):
        if boom.get(step, 0) > 0:
            boom[step] -= 1
            raise TransientFailure("injected")

    tr = _trainer(global_batch=4, seq_len=32, failure_hook=hook)
    state = tr.train(tr.init_state(), 25)
    tr.close()
    assert state.step == 25
    assert boom[20] == 0  # both injections fired and were retried
    assert len(tr.losses) == 25


def test_microbatch_grad_accum_equivalence():
    tr1 = _trainer(global_batch=8, seq_len=32, microbatches=1)
    tr2 = _trainer(global_batch=8, seq_len=32, microbatches=4)
    s1 = tr1.train(tr1.init_state(), 5)
    s2 = tr2.train(tr2.init_state(), 5)
    tr1.close()
    tr2.close()
    p2 = flatten_params(s2.params)
    for name, a in flatten_params(s1.params).items():
        np.testing.assert_allclose(a.detach().numpy(),
                                   p2[name].detach().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_data_pipeline_determinism_and_seek():
    p1 = DataPipeline(3, 4, 16, 100, prefetch=2)
    first = [next(p1) for _ in range(5)]
    p1.close()
    p2 = DataPipeline(3, 4, 16, 100, prefetch=0)
    p2.seek(3)
    b3 = next(p2)
    np.testing.assert_array_equal(b3, first[3])
    np.testing.assert_array_equal(
        synthetic_batch(3, 0, 4, 16, 100), first[0])


def test_heartbeat_registry_churn():
    reg = HeartbeatRegistry(stale_after_s=0.2)
    for n in range(8):
        assert reg.join(n)
    errs = []

    def checker():
        try:
            for _ in range(200):
                for n in range(8):
                    reg.alive(n)  # optimistic read-only scans
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def churner():
        try:
            for i in range(50):
                reg.leave(i % 8)
                reg.join(i % 8)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=f) for f in (checker, churner, checker)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    assert sorted(reg.snapshot()) == list(range(8))
    time.sleep(0.25)
    reg.heartbeat(0)
    assert reg.reap_stale() == 7
    assert reg.snapshot() == [0]


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=3.0)
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(1.0)          # 10× EMA → straggler
    assert wd.stats()["stragglers"] == 1
    assert abs(wd.ema - 0.1) < 1e-6  # straggler didn't poison the EMA


@pytest.mark.parametrize("arch,steps", [
    ("tinyllama-1.1b", 5), ("olmoe-1b-7b", 3), ("deepseek-v2-236b", 3),
    ("mamba2-1.3b", 3), ("zamba2-1.2b", 3)])
def test_trainer_matches_the_jax_trainer(arch, steps):
    """5 steps of the reduced TinyLlama (vocab 64, fp32, remat none,
    global batch 8 x 32) from the JAX trainer's init, bridged; 3 of each
    other family the JAX trainer trains (its batches carry tokens only, so
    neither trainer takes Qwen2-VL's patches or Whisper's frames)."""
    jtr = JTrainer(_tiny_cfg(jget_config, arch), global_batch=8, seq_len=32)
    jstate = jtr.train(jtr.init_state(), steps)
    jtr.close()
    tr = Trainer(_tiny_cfg(get_config, arch), global_batch=8, seq_len=32,
                 device="cpu")
    jinit = jax.tree_util.tree_map(np.asarray, jtr.init_state().params)
    params = from_jax_params(jinit, tr.cfg, "cpu")
    state = TrainState(params, tr.optimizer.init(flatten_params(params)), 0)
    state = tr.train(state, steps)
    tr.close()
    assert state.step == steps
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=2e-4, atol=2e-4)
    want = flatten_params(from_jax_params(jax.tree_util.tree_map(
        np.asarray, jstate.params), tr.cfg, "cpu"))
    for name, got in flatten_params(state.params).items():
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_bf16_checkpoint_round_trip_is_byte_exact(tmp_path, optimizer):
    cfg = get_config("tinyllama-1.1b").reduced().replace(
        dtype="bfloat16", vocab_size=64, optimizer=optimizer)
    tr = Trainer(cfg, global_batch=4, seq_len=16, device="cpu",
                 checkpoint_dir=tmp_path / "ck", checkpoint_every=100)
    state = tr.train(tr.init_state(), 2)      # the final save is blocking
    tr.close()
    restored = tr.restore()
    assert restored.step == state.step == 2
    assert tr.pipeline.index == 2
    got, want = (flatten_params(s.params) for s in (restored, state))
    assert all(t.dtype == torch.bfloat16 for t in want.values())
    for name, t in want.items():
        assert got[name].dtype == t.dtype
        assert torch.equal(_bits(got[name]), _bits(t)), name
    got, want = (flatten_tree(s.opt_state) for s in (restored, state))
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(_bits(got[name]), _bits(t)), name


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tinyllama-1.1b-reduced: step=2" in out
    loss = float(out.split("loss=")[1].split()[0])
    assert np.isfinite(loss)
