"""Prefix cache: the share of the window the engine thread spent
inserting finished requests into the prefix cache, with the SMR guards,
retires and reclaims the insert set off (span ``prefix_cache.insert``)."""
import hb_spans

UNIT = "%"
TRACED = True


def read(run):
    if hb_spans.delta(run, "span_n.prefix_cache.insert") <= 0:
        return None
    return 100.0 * hb_spans.delta(run, "span_s.prefix_cache.insert") / \
        run.seconds
