"""The MLA decode kernel's share of its roofline: what
``paged_attention.roofline`` reads, for a cell whose architecture names
the MLA decode launches as its ``DECODE_KERNELS`` (the absorbed form's
bytes and operations, ``archs/deepseek_v2.decode_attention_work``).  A
model without latent attention, or a run without decode rows or without
those launches in its slice, reads nothing."""
from hb_cell import plugin

UNIT = "%"
TRACED = True


def read(run):
    if "kv_lora_rank" not in run.cell.config:
        return None
    return plugin("metrics", "paged_attention.roofline").read(run)
