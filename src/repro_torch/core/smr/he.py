"""HE — hazard eras (Ramalhete & Correia 2017).  Robust.

Hazard *slots hold eras*, not pointers: ``protect`` publishes the current
global era to slot ``idx`` and loops until the era is stable across the read.
A retired node [birth_era, retire_era] is freed when no published slot era
falls inside its lifetime interval.  Same index discipline as HP, so SCOT's
``dup`` (copy the era) and one-shot recovery apply unchanged.
"""

from __future__ import annotations

from bisect import bisect_left

from .base import SmrScheme, ThreadCtx
from ..atomics import AtomicFlaggedRef, AtomicMarkableRef, AtomicRef, SmrNode


class HE(SmrScheme):
    name = "HE"
    robust = True
    cumulative_protection = False  # protect(idx) replaces the slot's era
    batch_hints = "flat"           # only slot-resident eras stay published

    def _publish_read(self, c: ThreadCtx, idx: int, read):
        if idx >= c.hwm:
            c.hwm = idx + 1
        prev_era = c.slots[idx]
        while True:
            value = read()
            era_now = self.era.load()
            if era_now == prev_era:
                return value
            c.slots[idx] = era_now
            c.n_barriers += 1
            prev_era = era_now

    def _reserve_markable(self, c, src: AtomicMarkableRef, idx: int):
        return self._publish_read(c, idx, src.get)

    def _reserve_plain(self, c, src: AtomicRef, idx: int):
        return self._publish_read(c, idx, src.load)

    def _reserve_flagged(self, c, src: AtomicFlaggedRef, idx: int):
        return self._publish_read(c, idx, src.get)

    def dup(self, src_idx: int, dst_idx: int, ctx=None) -> None:
        assert src_idx < dst_idx
        c = ctx if ctx is not None else self.ctx()
        if dst_idx >= c.hwm:
            c.hwm = dst_idx + 1
        c.slots[dst_idx] = c.slots[src_idx]
        c.n_barriers += 1

    def _on_begin(self, c: ThreadCtx) -> None:
        self._tick_era(c)

    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        self._retire_stamped(c, node)

    def _on_retire_batch(self, c: ThreadCtx, nodes) -> None:
        self._retire_stamped_batch(c, nodes)

    def _scan(self, c: ThreadCtx) -> None:
        """Set-based fast path: snapshot all published eras ONCE into a
        sorted scratch list, then answer "any era inside [birth, retire]?"
        per node with a bisect — O((E+R)·log E) instead of the O(R·E)
        per-node membership loop.  The retired list compacts in place."""
        c.n_scans += 1
        eras = c.scratch
        eras.clear()
        for t in self.all_ctxs():
            for s in t.slots:
                if s is not None:
                    eras.append(s)
        eras.sort()
        n_eras = len(eras)
        retired = c.retired
        w = 0
        for node in retired:
            # smallest published era >= birth; node is pinned iff it also
            # falls at or below retire (equivalent to any(birth<=e<=retire))
            i = bisect_left(eras, node.birth_era)
            if i < n_eras and eras[i] <= node.retire_era:
                retired[w] = node
                w += 1
            else:
                self._free(c, node)
        del retired[w:]
        eras.clear()
