"""Output tokens emitted inside the window, over the window's seconds."""
import hb_stats

UNIT = "tokens/s"


def read(run):
    return hb_stats.tokens_in(run.records, run.t0, run.t_end) / run.seconds
