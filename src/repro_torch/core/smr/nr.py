"""NR — no reclamation (leak). The paper's throughput upper-bound baseline."""

from __future__ import annotations

from .base import SmrScheme, ThreadCtx
from ..atomics import SmrNode


class NR(SmrScheme):
    name = "NR"
    robust = False
    cumulative_protection = True  # nothing is ever reclaimed → trivially safe
    reclaims = False              # the leak is the point
    batch_hints = "all"

    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        # Leak: count it, never free.
        c.retired.append(node)

    def _on_retire_batch(self, c: ThreadCtx, nodes) -> None:
        c.retired.extend(nodes)  # leak the whole chain, no scan trigger

    def _on_end(self, c: ThreadCtx) -> None:
        pass
