"""Host loop: the mean engine step that carries no prompt chunk (span
``step.decode``: admission, the decode launch, the sync, emit and
finish), in the window."""
import hb_spans

UNIT = "ms"
TRACED = True


def read(run):
    return hb_spans.mean_ms(run, "step.decode")
