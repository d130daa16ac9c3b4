"""Model step of an expert-layer model: what ``mfu.itl`` reads (the
architecture's ``token_flops`` of the slice's decode tokens over the
slice's seconds at the peak of the served type), for a cell whose
architecture counts its routed experts by the share this card holds.  A
model without routed experts, or a run without a slice or without decode
rows, reads nothing."""
from hb_cell import plugin

UNIT = "%"
TRACED = True


def read(run):
    if "n_routed_experts" not in run.cell.config:
        return None
    return plugin("metrics", "mfu.itl").read(run)
