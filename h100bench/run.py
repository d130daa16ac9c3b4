"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 h100bench/run.py --workload qwen3-32b.batch-decode --seed 7 \\
        --seconds 30 --trace 0

A cell ``<config>.<mix>`` is found by name (``configs/``, ``mixes/``,
``traffic/``, ``metrics/``, ``limits/`` beside this file).  The run makes
the weights on the card from the seed, serves the mix through
``repro_torch.serving`` for a lead-in and then ``--seconds`` measured
seconds, checks a seeded sample of what it served against the plain fp32
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, read from a profiled slice of the
window), ``device``, ``breakdown`` (traced runs) and ``checks``: each
compared number beside its limit, also printed last on standard error.
With no CUDA device, or where JAX was loaded, it prints no result and
exits 2 or 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths() -> None:
    """The benchmark's own modules and the port (``src/``) importable;
    every build and kernel cache inside the checkout."""
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    import hb_cell
    import hb_run
    cell = hb_cell.find_cell(args.workload)
    bench = hb_cell.load_json(ROOT / "BENCHMARK.json")
    listed = any(w["name"] == args.workload for w in bench["workloads"])
    metrics = hb_cell.metrics_of(args.workload, bool(args.trace), bench) \
        if listed else hb_cell.all_metrics(bool(args.trace))
    out = hb_run.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START, metrics)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
