"""Engine device functions: the share of the window's decode calls (the
dedicated decode steps and the decode riders of fused packed steps) that
replayed the shard's CUDA graph of the decode call
(``decode_graph_replays``) rather than launching it from Python, from
``session.stats()``.  A program without the counter reads nothing."""

UNIT = "%"
TRACED = True


def read(run):
    a, b = run.stats_a, run.stats_b
    if "decode_graph_replays" not in b:
        return None
    calls = (b["decode_steps"] - a.get("decode_steps", 0)) + \
        (b["rider_chunks"] - a.get("rider_chunks", 0))
    replays = b["decode_graph_replays"] - a.get("decode_graph_replays", 0)
    return 100.0 * replays / calls if calls > 0 else None
