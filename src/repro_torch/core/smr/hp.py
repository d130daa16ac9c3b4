"""HP — hazard pointers (Michael 2004).  Robust, per-pointer reservations.

``protect`` publishes the target pointer into a per-thread slot, then
re-reads the source word to validate the pointer is still installed there
(the paper's §2.4 discussion: validation succeeds iff the *source edge* is
intact, which is exactly the property SCOT's dangerous-zone check extends to
whole chains).  ``retire`` scans all threads' slots every ``retire_scan_freq``
retirements and frees nodes not present in any slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .base import SmrScheme, ThreadCtx
from ..atomics import AtomicFlaggedRef, AtomicMarkableRef, AtomicRef, SmrNode


class HP(SmrScheme):
    name = "HP"
    robust = True
    cumulative_protection = False  # protect(idx) cancels the old slot content
    batch_hints = "flat"           # only slot-resident nodes stay pinned

    # ------------------------------------------------------------ protect
    def _reserve_markable(self, c: ThreadCtx, src: AtomicMarkableRef, idx: int):
        if idx >= c.hwm:
            c.hwm = idx + 1
        while True:
            word = src.get()
            c.slots[idx] = word[0]
            c.n_barriers += 1
            if src.get() is word:        # validate: source edge intact
                return word

    def _reserve_plain(self, c: ThreadCtx, src: AtomicRef, idx: int):
        if idx >= c.hwm:
            c.hwm = idx + 1
        while True:
            ref = src.load()
            c.slots[idx] = ref
            c.n_barriers += 1
            if src.load() is ref:
                return ref

    def _reserve_flagged(self, c: ThreadCtx, src: AtomicFlaggedRef, idx: int):
        if idx >= c.hwm:
            c.hwm = idx + 1
        while True:
            word = src.get()
            c.slots[idx] = word[0]
            c.n_barriers += 1
            if src.get() is word:
                return word

    def dup(self, src_idx: int, dst_idx: int, ctx=None) -> None:
        assert src_idx < dst_idx
        c = ctx if ctx is not None else self.ctx()
        if dst_idx >= c.hwm:
            c.hwm = dst_idx + 1
        c.slots[dst_idx] = c.slots[src_idx]
        c.n_barriers += 1

    # ------------------------------------------------------------- retire
    def _scan(self, c: ThreadCtx) -> None:
        """Set-based fast path: the hazard snapshot is built ONCE into a
        reusable per-thread scratch set, and the retired list is compacted
        in place (no per-scan ``keep`` list allocation)."""
        c.n_scans += 1
        hazards = c.scratch_set
        hazards.clear()
        for t in self.all_ctxs():
            # ascending slot order — pairs with the ascending `dup` rule
            for s in t.slots:
                if s is not None:
                    hazards.add(id(s))
        retired = c.retired
        w = 0
        for node in retired:
            if id(node) in hazards:
                retired[w] = node
                w += 1
            else:
                self._free(c, node)
        del retired[w:]
        hazards.clear()
