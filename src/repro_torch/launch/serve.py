"""Serving launcher, ported from the JAX package's ``launch/serve.py``.

    python -m repro_torch.launch.serve                 # reduced, fp32
    python -m repro_torch.launch.serve --no-reduced --dtype bfloat16

It serves ``--requests`` prompts of 12 tokens drawn from
``RandomState(0)``, 8 new tokens each, greedy, on ``ServingConfig(
num_pages=128, page_size=8, max_batch=4, max_seq_len=64)`` and prints the
reference's line ``[serve] <name> smr=<smr> shards=<n>: <totals>``.  As the
reference it serves the reduced config in fp32 by default;
``--no-reduced`` serves the config at its published widths,
``--dtype`` overrides the dtype, and ``--device`` (default ``cuda``)
names the device (``cpu`` runs the kernels' plain versions).  Weights are
seeded random (seed 0)."""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config
from ..models import build_model
from ..serving import ServingConfig, serve


def prompts(n: int):
    """The launcher's ``n`` prompts: 12 tokens each from RandomState(0)."""
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, 200, size=12)) for _ in range(n)]


def setup(args):
    """(cfg, model, params, ServingConfig) for parsed ``args``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    config = ServingConfig(smr=args.smr, num_shards=args.shards,
                           num_pages=128, page_size=8, max_batch=4,
                           max_seq_len=64)
    return cfg, model, params, config


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smr", default="IBR")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config in fp32 (default); --no-reduced "
                    "serves the published config")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve, print the totals line; returns ``{"name", "tokens" (one
    list per request, in order), "totals"}``."""
    args = parse(argv)
    cfg, model, params, config = setup(args)
    with serve(model, params, config, device=args.device) as session:
        handles = session.submit_many(prompts(args.requests),
                                      max_new_tokens=8)
        for h in handles:
            h.wait(timeout=300)
        tokens = [list(h.out_tokens) for h in handles]
        totals = session.stats()["totals"]
    print(f"[serve] {cfg.name} smr={args.smr} shards={args.shards}: "
          f"{totals}")
    return {"name": cfg.name, "tokens": tokens, "totals": totals}


if __name__ == "__main__":
    main()
