"""Device: the mean wait of the step's one device-to-host sync, the sampled
tokens' read-back (span ``sample.wait``), in the window: the device work
still queued when the host has launched all of it."""
import hb_spans

UNIT = "ms"
TRACED = True


def read(run):
    return hb_spans.mean_ms(run, "sample.wait")
