"""Host loop: decode tokens emitted in the traced run's window (every
output token but a request's first, which its prefill gives) over the
decode steps that made them (dedicated decode steps and the decode riders
of fused packed steps, from ``session.stats()``)."""
import hb_stats

UNIT = "rows"
TRACED = True


def read(run):
    a, b = run.stats_a, run.stats_b
    steps = (b["decode_steps"] - a.get("decode_steps", 0)) + \
        (b["rider_chunks"] - a.get("rider_chunks", 0))
    tokens = hb_stats.tokens_in(run.records, run.t0, run.t_end) - sum(
        1 for r in run.records
        if r.out_times and run.t0 <= r.out_times[0] < run.t_end)
    return tokens / steps if steps > 0 and tokens > 0 else None
