"""Readings for a cell's limits: the program's and the control's widest
gaps on many seeds, in one process (the set-up is paid once for the
kernels; the weights are made anew from each seed).

    python3 h100bench/control.py --workload qwen3-32b.batch-decode \\
        --seeds 11,12,13 --seconds 20 [--no-control] [--fault NAME] \\
        [--out FILE]

For each seed it runs the cell at its own load and sizes for ``--seconds``
measured seconds, then reads the sample through the fp32 reference and,
unless ``--no-control``, through the fp8 control, and prints one JSON
line: the seed, the end-to-end metrics, the readings, and the verdicts of
the program and the control under the cell's limits.  With ``--fault``
the program runs with that fault of :mod:`hb_faults` planted.  The
benchmark's own runs never run the control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of hb_faults.FAULTS in the program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_run.setup_paths()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import hb_cell
    import hb_run
    cell = hb_cell.find_cell(args.workload)
    if args.fault:
        import hb_faults
        hb_faults.plant(args.fault)
    metrics = hb_cell.all_metrics(False)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = hb_run.run_cell(cell, seed, args.seconds, False, "cuda",
                              t_start, metrics,
                              control=not args.no_control)
        out.pop("run")
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, **out}
        text = json.dumps(line)
        print(text, flush=True)
        if "worst_greedy_gap" in out["readings"]:
            print(f"[worst_greedy_gap] seed={seed} "
                  f"{out['readings']['worst_greedy_gap']}",
                  file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
