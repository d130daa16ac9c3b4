"""Host loop: the mean wait of the requests admitted in the window, from
submit to admission (pages reserved): span ``request.queue``, recorded
once a request from its two stamps."""
import hb_spans

UNIT = "ms"
TRACED = True


def read(run):
    return hb_spans.mean_ms(run, "request.queue")
