"""Same-call A/B of the bf16 flash tensor-core kernel against another tree's.

    python3 benchmarks/torch_flash_ab.py --base DIR [--rounds 4]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this checkout
and of ``DIR`` (an unpacked ``git archive`` of another commit, such as the
parent), each with the flags of ``repro_torch.kernels.build``, one ``nvcc``
each, started together.  Then, on one card, it times the bf16 tensor-core
launcher (``flash_attention_tc_launch``) of both builds at phase 7's bf16
shapes of ``chip_smoke.py``: in each round the base, this tree's 64-row
tile, this tree's 64-row tile again, the base again, and then this tree's
128-row tile where :func:`query_rows` picks it.  Each reading is the
CUDA-event mean of 20 launches with the L2 flushed before each and the
``torch.profiler`` device time of one call (``chip_smoke.Timer`` and
``chip_smoke.profiled_ms``).  Outputs are held against each other at
bf16's 2e-2.

It also compares the machine code of the one-warpgroup D = 64 kernel of
both builds (``cuobjdump -sass``, with addresses and encodings dropped).

Prints the card line, one JSON line a shape (every reading, and the median
of each build) and one for the machine code; needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
CSRC = os.path.join("src", "repro_torch", "kernels", "csrc")

# phase 7's bf16 rows: (B, Sq, Sk, H, Hkv, D, causal)
SHAPES = [(4, 1024, 1024, 32, 32, 64, True), (4, 1024, 1024, 32, 4, 64, True),
          (4, 1500, 1500, 8, 8, 64, False), (4, 448, 1500, 8, 8, 64, False),
          (2, 1024, 1024, 64, 8, 128, True),
          (2, 1024, 1024, 128, 128, 192, True)]


def build_both(base: str, out: str):
    """Compile both trees' flash_attention.cu into ``out``; returns
    {"base": path, "this": path}."""
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    os.makedirs(out, exist_ok=True)
    procs = {}
    for tag, tree in (("base", base), ("this", ROOT)):
        csrc = os.path.join(tree, CSRC)
        lib = os.path.join(out, f"libflash_{tag}.so")
        procs[tag] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(csrc, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed:\n{log.decode()}")
        libs[tag] = lib
    return libs


def launcher(lib_path: str, with_rows: bool):
    """The library's bf16 tensor-core launcher, called as
    ``fn(q, k, v, out, causal, rows)`` on the current stream."""
    import torch
    fn = ctypes.CDLL(lib_path).flash_attention_tc_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_float] + [ctypes.c_int] * with_rows + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, out, causal, rows):
        b, sq, h, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, h, hkv, d, int(causal), d ** -0.5]
        err = fn(*args, *([rows] if with_rows else []),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: CUDA error {err}")
        return out
    return call


def sass_of(lib_path: str, pattern: str):
    """Instructions of the one kernel of ``lib_path`` whose name matches
    ``pattern``, without addresses or encodings."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = re.search(pattern, line) is not None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if inside and m:
            out.append(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="root of the other tree (git archive, unpacked)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "flash_ab"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: no CUDA device")
    print(cs.card_line(), flush=True)
    libs = build_both(args.base, args.out)
    with open(os.path.join(args.base, CSRC, "flash_attention.cu")) as f:
        base_rows = re.search(r"flash_attention_tc_launch\([^)]*int rows",
                              f.read()) is not None
    run = {"base": launcher(libs["base"], base_rows),
           "this": launcher(libs["this"], True)}

    old = sass_of(libs["base"], r"flash_tc_kernelILi64E(EE|Li1EEE)")
    new = sass_of(libs["this"], r"flash_tc_kernelILi64E(EE|Li1EEE)")
    diff = [ln for ln in difflib.unified_diff(old, new, lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    print(json.dumps({"sass_d64_one_warpgroup": {
        "base_instructions": len(old), "this_instructions": len(new),
        "identical": old == new, "changed_lines": len(diff),
        "first_changes": diff[:12]}}), flush=True)

    timer = cs.Timer(torch)
    for b, sq, sk, h, hkv, d, causal in SHAPES:
        rng = np.random.RandomState(sq + hkv + d)
        q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to("cuda", torch.bfloat16) for s in
            ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        outs = {}
        calls = {"base": lambda: run["base"](q, k, v, outs["base"], causal,
                                             64),
                 "this64": lambda: run["this"](q, k, v, outs["this64"],
                                               causal, 64)}
        if fa.query_rows(d) != 64:
            calls["this128"] = lambda: run["this"](q, k, v, outs["this128"],
                                                   causal, 128)
        for tag in calls:
            outs[tag] = torch.empty_like(q)
            calls[tag]()
        torch.cuda.synchronize()
        errs = {tag: float((outs[tag].float() - outs["base"].float()).abs()
                           .max()) for tag in calls if tag != "base"}
        if max(errs.values()) > 2e-2:
            raise AssertionError(f"{(b, sq, sk, h, hkv, d)}: builds differ "
                                 f"{errs}")
        order = ["base", "this64", "this64", "base"] + \
            (["this128"] if "this128" in calls else [])
        events = {tag: [] for tag in calls}
        device = {tag: [] for tag in calls}
        for _ in range(args.rounds):
            for tag in order:
                events[tag].append(timer.ms(calls[tag]))
                device[tag].append(cs.profiled_ms(torch, timer, calls[tag],
                                                  ("flash_tc_kernel",)))
        print(json.dumps({
            "shape": {"b": b, "sq": sq, "sk": sk, "h": h, "hkv": hkv, "d": d,
                      "causal": causal},
            "max_abs_diff_to_base": errs,
            "median_event_ms": {t: statistics.median(x)
                                for t, x in events.items()},
            "median_device_ms": {t: statistics.median(x)
                                 for t, x in device.items()},
            "event_ms": events, "device_ms": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
