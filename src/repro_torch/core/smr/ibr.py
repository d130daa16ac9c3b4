"""IBR — interval-based reclamation (Wen et al. 2018), 2GE-IBR flavour.

Each thread reserves one era *interval* [lower, upper]: ``begin_op`` sets both
to the current era, every ``protect`` bumps ``upper`` to the current era
(cumulative — earlier reservations are never cancelled, which is why SCOT's
ring-buffer recovery applies, paper §3.2.1).  A retired node [birth, retire]
is freed when no thread interval overlaps it.  Robust: a stalled thread's
frozen upper bound only pins nodes *born before* its stall.
"""

from __future__ import annotations

from bisect import bisect_right

from .base import SmrScheme, ThreadCtx
from ..atomics import AtomicFlaggedRef, AtomicMarkableRef, AtomicRef, SmrNode


class IBR(SmrScheme):
    name = "IBR"
    robust = True
    cumulative_protection = True
    batch_hints = "all"

    def _on_begin(self, c: ThreadCtx) -> None:
        e = self.era.load()
        c.lower = e
        c.upper = e
        c.n_barriers += 1
        self._tick_era(c)

    def _on_end(self, c: ThreadCtx) -> None:
        c.lower = 0
        c.upper = 0

    def _bump(self, c: ThreadCtx, read):
        while True:
            value = read()
            e = self.era.load()
            if e == c.upper:
                return value
            c.upper = e          # publish wider interval, re-read
            c.n_barriers += 1

    def _reserve_markable(self, c, src: AtomicMarkableRef, idx: int):
        return self._bump(c, src.get)

    def _reserve_plain(self, c, src: AtomicRef, idx: int):
        return self._bump(c, src.load)

    def _reserve_flagged(self, c, src: AtomicFlaggedRef, idx: int):
        return self._bump(c, src.get)

    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        self._retire_stamped(c, node)

    def _on_retire_batch(self, c: ThreadCtx, nodes) -> None:
        self._retire_stamped_batch(c, nodes)

    def _scan(self, c: ThreadCtx) -> None:
        """Set-based fast path: snapshot the reservation intervals ONCE into
        sorted scratch arrays (lowers ascending, running max of uppers), then
        each node's overlap test — "∃ [lo,hi]: lo ≤ retire AND hi ≥ birth" —
        is a bisect over the lowers plus one prefix-max lookup, instead of
        the O(threads) membership loop per retired node.  Compacts the
        retired list in place."""
        c.n_scans += 1
        intervals = c.scratch
        max_hi = c.scratch2
        intervals.clear()
        max_hi.clear()
        for t in self.all_ctxs():
            if t.active and t.lower > 0:
                intervals.append((t.lower, t.upper))
        intervals.sort()
        running = 0
        for _, hi in intervals:
            running = hi if hi > running else running
            max_hi.append(running)
        inf = float("inf")
        retired = c.retired
        w = 0
        for node in retired:
            # intervals with lo <= retire_era are intervals[:i] (the inf
            # sentinel makes the probe compare on lo alone); the node is
            # pinned iff the widest of their uppers reaches back to birth
            i = bisect_right(intervals, (node.retire_era, inf))
            if i and max_hi[i - 1] >= node.birth_era:
                retired[w] = node
                w += 1
            else:
                self._free(c, node)
        del retired[w:]
        intervals.clear()
        max_hi.clear()
