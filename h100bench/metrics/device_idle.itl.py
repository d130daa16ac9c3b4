"""Device: the share of the traced slice in which no kernel ran (the
union of every kernel's interval in the profiler's trace, against the
slice's length on the host's clock)."""

UNIT = "%"
TRACED = True


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - sl.busy_s / sl.window_s)
