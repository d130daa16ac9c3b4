"""Host loop: the mean engine step that carries a prompt chunk, with or
without decode riders (span ``step.chunk``), in the window: the steps
behind the tail of the gaps between tokens."""
import hb_spans

UNIT = "ms"
TRACED = True


def read(run):
    return hb_spans.mean_ms(run, "step.chunk")
