"""Paged decode kernel: the least time of the traced slice's decode
attention (the architecture's ``decode_attention_work`` for the engine's
``decode_rows`` and ``decode_kv_tokens`` over the slice: keys and values
read once, queries read, outputs written, at 3.35 TB/s) over the device
time of the architecture's ``DECODE_KERNELS`` in the slice."""
import torch

import hb_roofline
import hb_trace

UNIT = "%"
TRACED = True


def read(run):
    sl = run.slice
    if sl is None:
        return None
    arch, cfg = run.cell.arch, run.cell.config
    rows, keys = hb_trace.slice_decode_work(sl)
    dev_s = sl.kernel_s(arch.DECODE_KERNELS)
    if not rows or dev_s <= 0:
        return None
    dtype = cfg["torch_dtype"]
    nbytes, flops = arch.decode_attention_work(
        cfg, rows, keys, getattr(torch, dtype).itemsize)
    ms, _ = hb_roofline.bound(nbytes, flops, dtype)
    return 100.0 * ms / 1e3 / dev_s
