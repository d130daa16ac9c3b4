"""Roofline analysis of the dry run's records, ported from the JAX
package's ``launch/roofline.py`` with the H100's constants.

Per (arch x shape x mesh):
    compute term    = FLOPs_per_device / peak FLOP/s
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth
(all in seconds; the dominant term is the bottleneck).  MODEL_FLOPS is the
analytic 6·N·D (train) / 2·N·D (serve) with N the *active* parameters for
MoE; MODEL / counted FLOPs exposes remat and redundancy.

Hardware constants: NVIDIA H100 SXM5 80 GB (the datasheet's SXM5 column),
the card ``nvidia-smi`` names "NVIDIA H100 80GB HBM3" at a 700 W limit:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4
at 900 GB/s per card, 450 GB/s in each direction.  The dry run's bytes
count unfused aten ops (``bytes_basis``), so the memory term runs higher
than a fused program's would."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

PEAK_FLOPS = 989e12      # bf16 dense, tensor cores
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # NVLink 4, bytes/s per direction


def count_params(arch: str):
    """(N_total, N_active, cfg), excluding the input embedding table;
    counted from the parameters on ``meta``."""
    from ..configs import get_config
    from ..models.params import abstract_params, flatten_params
    cfg = get_config(arch)
    params, _ = abstract_params(cfg)
    total = embed = 0
    for name, p in flatten_params(params).items():
        n = int(np.prod(p.shape))
        total += n
        if "embed" in name.split("/"):
            embed += n
    n_eff = total - embed
    # MoE: non-activated routed experts don't contribute FLOPs
    n_active = n_eff
    if cfg.n_experts:
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        inactive = (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
        n_active = n_eff - inactive
    return n_eff, n_active, cfg


def model_flops(arch: str, shape_kind: str, seq_len: int, global_batch: int):
    n_eff, n_active, cfg = count_params(arch)
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


def analyze_record(rec: dict, shapes_table) -> dict:
    chips = rec["n_chips"]
    t_compute = rec["flops_per_device"] / PEAK_FLOPS
    t_memory = rec["bytes_accessed_per_device"] / HBM_BW
    t_coll = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    shape = shapes_table[rec["shape"]]
    mf = model_flops(rec["arch"], rec["kind"], shape.seq_len,
                     shape.global_batch)
    counted = rec["flops_per_device"] * chips
    ratio = mf / counted if counted > 0 else float("nan")
    # roofline fraction: useful model flops against what peak silicon could
    # do in the bottleneck term's time
    frac = (mf / chips / PEAK_FLOPS) / max(terms[dominant], 1e-30)
    return {
        **rec,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": mf,
        "counted_flops_global": counted,
        "model_over_counted": ratio,
        "roofline_fraction": frac,
    }


_SUGGESTIONS = {
    "compute": ("reduce recompute (remat policy) or shrink the "
                "MODEL/counted gap — compute-bound is the good end state"),
    "memory": ("raise arithmetic intensity: fused kernels, larger tiles, "
               "wider per-device batch, or bf16 the dominant buffers"),
    "collective": ("reshard to cut the dominant collective: FSDP→TP balance "
                   "for all-gathers, hierarchical/compressed reduce across "
                   "pods, or overlap with compute"),
}


def format_table(records, title="Roofline (single-pod 16×16, H100)"):
    lines = [
        f"### {title}",
        "",
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL/counted | roofline frac | what moves it |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skipped* | — "
                f"| — | {r['reason']} |")
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | **ERROR** | — "
                f"| — | see dryrun log |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['dominant']} "
            f"| {r['model_over_counted']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {_SUGGESTIONS[r['dominant']]} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", default="experiments/dryrun")
    ap.add_argument("--preset", default="baseline")
    ap.add_argument("--out", default="experiments/roofline.md")
    args = ap.parse_args(argv)

    from ..configs.base import SHAPES
    recs = []
    for path in sorted(Path(args.records).glob(f"*__{args.preset}.json")):
        rec = json.loads(path.read_text())
        if "error" in rec or rec.get("skipped"):
            recs.append(rec)
            continue
        recs.append(analyze_record(rec, SHAPES))

    single = [r for r in recs if not r.get("multi_pod")]
    multi = [r for r in recs if r.get("multi_pod")]
    text = "\n".join([format_table(single), "",
                      format_table(multi, "Roofline (multi-pod 2×16×16, "
                                   "H100)")])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)
    return recs


if __name__ == "__main__":
    main()
