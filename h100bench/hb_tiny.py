"""A cell cut to a size the CPU serves in seconds, for the benchmark's
own tests: the real cell's files with every width and length shrunk (the
widths by the architecture's ``tiny``), run through the harness with the
chip's look skipped, and judged by the real cell's limits."""

import time

from hb_cell import Cell, all_metrics, find_cell

CELL = "qwen3-32b.batch-decode"


def tiny_cell(workload: str = CELL, dtype: str = "float32"):
    """The cell ``workload`` at its architecture's tiny widths, served on
    the CPU by four clients: every length shrunk so a run takes a few
    seconds; every finished request checked, by the cell's own limits."""
    cell = find_cell(workload)
    cfg = cell.arch.tiny(cell.config)
    mix = cell.mix
    cfg["torch_dtype"] = dtype
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
