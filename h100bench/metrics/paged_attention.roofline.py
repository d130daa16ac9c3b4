"""Paged decode kernel: the least time of the traced slice's paged calls
(their keys and values read once, queries read, outputs written, at
3.35 TB/s) over the device time of the paged kernels in the slice."""
import hb_roofline
import hb_trace

UNIT = "%"
TRACED = True


def read(run):
    sl = run.slice
    if sl is None or not sl.paged:
        return None
    dev_s = sl.kernel_s(hb_roofline.PAGED)
    if dev_s <= 0:
        return None
    nbytes, flops = hb_trace.paged_bytes_ops(sl, run.cell.config)
    ms, _ = hb_roofline.bound(nbytes, flops, run.cell.config["torch_dtype"])
    return 100.0 * ms / 1e3 / dev_s
