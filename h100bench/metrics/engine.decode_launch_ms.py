"""Model step: the mean host time of one decode call, from its operands to
logits in hand with no sync (span ``decode.launch``, dedicated steps and
riders alike), in the window."""
import hb_spans

UNIT = "ms"
TRACED = True


def read(run):
    return hb_spans.mean_ms(run, "decode.launch")
