"""Training launcher, ported from the JAX package's ``launch/train.py``.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100
    python -m repro_torch.launch.train --arch tinyllama-1.1b --no-reduced \\
        --steps 20 --seq-len 1024

By default it trains the reduced config in fp32 without remat, as the
reference does; ``--no-reduced`` trains the config at its published widths
and dtype (the reference's ``--reduced`` is on whatever the command line
says).  ``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU."""

from __future__ import annotations

import argparse

from ..configs import ALL_ARCHS, get_config
from ..train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config in fp32 without remat (default); "
                    "--no-reduced trains the published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32", remat="none")
    tr = Trainer(cfg, global_batch=args.global_batch, seq_len=args.seq_len,
                 microbatches=args.microbatches,
                 checkpoint_dir=args.ckpt_dir, total_steps=args.steps,
                 device=args.device)
    state = tr.restore_or_init() if args.resume else tr.init_state()
    state = tr.train(state, args.steps)
    print(f"[train] {cfg.name}: step={state.step} "
          f"loss={tr.losses[-1]:.4f} watchdog={tr.watchdog.stats()}")
    tr.close()


if __name__ == "__main__":
    main()
