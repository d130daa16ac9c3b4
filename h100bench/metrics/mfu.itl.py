"""Model step: model FLOPs of the traced slice's decode tokens (two a
matrix parameter of every layer, the output head, attention over each
token's context) over the slice's seconds at the bf16 peak."""
import hb_roofline
import hb_trace

UNIT = "%"
TRACED = True


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    tokens, keys = hb_trace.slice_decode_work(sl, run.cell.config)
    if not tokens:
        return None
    flops = hb_roofline.token_flops(run.cell.config, tokens, keys, tokens)
    peak = hb_roofline.PEAK_FLOPS[run.cell.config["torch_dtype"]]
    return 100.0 * flops / (sl.window_s * peak)
