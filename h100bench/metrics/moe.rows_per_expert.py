"""Expert layer: the (token, choice) pairs that decode calls routed to
the experts this card holds (``moe_decode_local_pairs``) over the
window, per held expert and expert-layer pass (``moe_decode_passes``),
from ``session.stats()``: the rows each held expert's products see in a
decode step.  A program without the two counters, or a model without
expert layers, reads nothing."""

UNIT = "rows"
TRACED = True


def read(run):
    a, b = run.stats_a, run.stats_b
    if "moe_decode_passes" not in b or "moe_decode_local_pairs" not in b:
        return None
    passes = b["moe_decode_passes"] - a.get("moe_decode_passes", 0)
    if passes <= 0:
        return None
    pairs = b["moe_decode_local_pairs"] - a.get("moe_decode_local_pairs", 0)
    return pairs / (run.cell.config["n_routed_experts"] * passes)
