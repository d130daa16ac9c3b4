"""Model step: model FLOPs of the traced slice's decode tokens (the
architecture's ``token_flops``: two a matrix parameter a token of the
active ones, the output head, attention over each token's context) over
the slice's seconds at the peak of the served type.  The tokens and the
keys they attend are the engine's ``decode_rows`` and
``decode_kv_tokens`` over the slice."""
import hb_roofline
import hb_trace

UNIT = "%"
TRACED = True


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    rows, keys = hb_trace.slice_decode_work(sl)
    if not rows:
        return None
    cfg = run.cell.config
    flops = run.cell.arch.token_flops(cfg, rows, keys, rows)
    peak = hb_roofline.PEAK_FLOPS[cfg["torch_dtype"]]
    return 100.0 * flops / (sl.window_s * peak)
