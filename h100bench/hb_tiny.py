"""A Qwen3 cell cut to a size the CPU serves in seconds, for the
benchmark's own tests: the real cell's files with every width and length
shrunk, run through the harness with the chip's look skipped, and judged
by the real cell's limits."""

import time

from hb_cell import Cell, all_metrics, find_cell

CELL = "qwen3-32b.batch-decode"


def tiny_cell(workload: str = CELL, dtype: str = "float32"):
    """The cell ``workload`` on an eight-layer Qwen3 of width 128, served
    on the CPU by four clients: every length shrunk so a run takes a few
    seconds; every finished request checked, by the cell's own limits.
    (At two layers of width 64 a decode step that leaves the pages
    unchanged reads 0.30-0.65, about the cell's limit; at eight of 128,
    0.53 and more.)"""
    cell = find_cell(workload)
    cfg, mix = cell.config, cell.mix
    cfg.update(hidden_size=128, intermediate_size=384, num_attention_heads=8,
               num_key_value_heads=2, head_dim=16, num_hidden_layers=8,
               vocab_size=512, torch_dtype=dtype)
    cfg["engine"].update(num_pages=1024, max_batch=4, max_seq_len=512,
                         prefill_chunk_tokens=64)
    mix["lead_s"] = 0.3
    mix["trace"] = {"slice_s": 0.5}
    mix["check"].update(served_tokens=10**6, max_tokens=10**6)
    mix["params"].update(clients=4, prompt={"min": 16, "max": 64},
                         output={"min": 4, "max": 24})
    return Cell(f"tiny.{workload}", cfg, mix, cell.limits)


def tiny_run(cell, seed: int = 2**31 + 17, seconds: float = 3.0,
             trace: bool = False, control: bool = False):
    """One CPU run of ``cell`` through the harness (the chip's look
    skipped)."""
    import hb_run
    return hb_run.run_cell(cell, seed, seconds, trace, "cpu",
                           time.perf_counter(),
                           all_metrics(trace), control=control)
