"""EBR — epoch-based reclamation (Fraser).  Fast, easy, NOT robust.

Reservation = the global epoch observed at ``begin_op``.  A node retired at
epoch *r* is freed once every active thread's entry epoch is > *r* (any thread
that could still hold the node must have entered before the node was retired,
hence published an epoch ≤ *r*).  A stalled thread freezes its entry epoch and
blocks everything retired afterwards — unbounded garbage (paper §1, property A
violation; demonstrated by tests/test_robustness.py).
"""

from __future__ import annotations

from .base import SmrScheme, ThreadCtx
from ..atomics import SmrNode


class EBR(SmrScheme):
    name = "EBR"
    robust = False
    cumulative_protection = True  # plain loads; no per-pointer reservations
    batch_hints = "all"

    def _on_begin(self, c: ThreadCtx) -> None:
        c.epoch = self.era.load()
        c.n_barriers += 1  # publishing the reservation is a fenced store
        self._tick_era(c)

    def _on_end(self, c: ThreadCtx) -> None:
        c.epoch = None

    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        self._retire_stamped(c, node)

    def _on_retire_batch(self, c: ThreadCtx, nodes) -> None:
        self._retire_stamped_batch(c, nodes)

    def _scan(self, c: ThreadCtx) -> None:
        # the epoch snapshot was already a single min(); the fast path here
        # is the in-place compaction (no per-scan keep-list allocation)
        c.n_scans += 1
        active = [t.epoch for t in self.all_ctxs() if t.epoch is not None]
        min_epoch = min(active) if active else self.era.load() + 1
        retired = c.retired
        w = 0
        for node in retired:
            if node.retire_era < min_epoch:
                self._free(c, node)
            else:
                retired[w] = node
                w += 1
        del retired[w:]
