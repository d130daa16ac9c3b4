"""End-to-end training example on the torch port: train a reduced LM for a
few hundred steps with async checkpointing, failure-retry and straggler
tracking.

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --arch tinyllama-1.1b --steps 200 --global-batch 8
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20   # the card

The port's counterpart of ``examples/train_lm.py`` on
``repro_torch.train.loop.Trainer``: the same flags, defaults and printed
lines, the reduced config in fp32 without remat, a checkpoint every 50
steps and one at the end of the run (``Trainer.train`` saves its last
step), so ``--resume`` restarts from the step the last run reached.  It
adds ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions; with no card the default raises), and its default
``--ckpt-dir`` is ``repro_torch_ckpt`` under the temporary directory,
apart from the reference's."""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.train.loop import Trainer


def main(argv=None):
    """Train and print the reference's lines; returns ``{"start", "step",
    "losses"}`` (the step the run started from and ended at, and this
    run's losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced().replace(dtype="float32",
                                                  remat="none")
    tr = Trainer(cfg, global_batch=args.global_batch, seq_len=args.seq_len,
                 microbatches=args.microbatches, lr=args.lr,
                 checkpoint_dir=args.ckpt_dir, checkpoint_every=50,
                 total_steps=args.steps, device=args.device)
    state = tr.restore_or_init() if args.resume else tr.init_state()
    start = state.step
    print(f"training {cfg.name} from step {state.step} "
          f"for {args.steps} steps …")
    state = tr.train(state, args.steps)
    losses = tr.losses
    for i in range(0, len(losses), max(1, len(losses) // 10)):
        print(f"  step {state.step - len(losses) + i:4d}  "
              f"loss {losses[i]:.4f}")
    print(f"final loss {losses[-1]:.4f} "
          f"(start {np.mean(losses[:5]):.4f}) "
          f"straggler stats: {tr.watchdog.stats()}")
    tr.close()
    return {"start": start, "step": state.step, "losses": list(losses)}


if __name__ == "__main__":
    main()
