"""95th percentile over every gap between consecutive tokens of a request
emitted in the window, preemption and migration gaps included; a request
still open at the window's end adds its open gap."""
import hb_stats

UNIT = "ms"


def read(run):
    v = hb_stats.p95(hb_stats.itl_values(run.records, run.t0, run.t_end))
    return None if v is None else v * 1e3
