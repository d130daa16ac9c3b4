"""Hyaline-1S (Nikolaev & Ravindran 2021) — robust, scan-free reclamation.

Distinctive mechanism (vs HP/HE/IBR's retire-list *scans*): retired nodes are
grouped into **batches**; at seal time the batch is handed to the threads that
could still hold references (a reference counter), and each thread *releases*
its reference when leaving its operation (``end_op``).  Reclamation work is
thus distributed across leaving threads — no O(threads) scan on the retire
path.

Robustness ("1S" era single-slot): threads publish an era interval
[lower, upper] like IBR; a sealed batch is only pinned by threads whose
interval can overlap a batch lifetime ([min birth, seal era]).  A stalled
thread's frozen ``upper`` pins only batches containing nodes born before the
stall — bounded garbage (tests/test_robustness.py).

Like IBR, protection is *cumulative*, so SCOT's ring-buffer recovery applies
(paper §3.2.1, Figure 6).
"""

from __future__ import annotations

import threading
from typing import List

from .base import SmrScheme, ThreadCtx
from ..atomics import AtomicFlaggedRef, AtomicInt, AtomicMarkableRef, AtomicRef, SmrNode


class _Batch:
    __slots__ = ("nodes", "refs", "min_birth", "retire_era")

    def __init__(self, nodes: List[SmrNode], min_birth: int, retire_era: int):
        self.nodes = nodes
        self.refs = AtomicInt(0)
        self.min_birth = min_birth
        self.retire_era = retire_era


class Hyaline1S(SmrScheme):
    name = "HLN"
    robust = True
    cumulative_protection = True
    batch_hints = "all"

    def __init__(self, *args, batch_size: int = 16, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_size = batch_size
        self._seal_lock = threading.Lock()

    # --------------------------------------------------------- reservation
    def _on_begin(self, c: ThreadCtx) -> None:
        e = self.era.load()
        c.lower = e
        c.upper = e
        c.n_barriers += 1
        self._tick_era(c)

    def _bump(self, c: ThreadCtx, read):
        while True:
            value = read()
            e = self.era.load()
            if e == c.upper:
                return value
            c.upper = e
            c.n_barriers += 1

    def _reserve_markable(self, c, src: AtomicMarkableRef, idx: int):
        return self._bump(c, src.get)

    def _reserve_plain(self, c, src: AtomicRef, idx: int):
        return self._bump(c, src.load)

    def _reserve_flagged(self, c, src: AtomicFlaggedRef, idx: int):
        return self._bump(c, src.get)

    # ------------------------------------------------------------- retire
    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        node.retire_era = self.era.load()
        pending = c.pending
        pending.append(node)
        self._tick_era(c)
        if len(pending) >= self.batch_size:
            self._seal(c, pending)
            c.pending = []

    def _on_retire_batch(self, c: ThreadCtx, nodes) -> None:
        # whole chain joins the pending batch under ONE era read and one
        # coalesced tick; an oversize batch seals as a single unit (the
        # distribution-of-release semantics don't care about batch size)
        e = self.era.load()
        pending = c.pending
        for node in nodes:
            node.retire_era = e
            pending.append(node)
        self._tick_era_n(c, len(nodes))
        if len(pending) >= self.batch_size:
            self._seal(c, pending)
            c.pending = []

    def _seal(self, c: ThreadCtx, nodes: List[SmrNode]) -> None:
        if not nodes:
            return
        min_birth = min(n.birth_era for n in nodes)
        retire_era = self.era.load()
        batch = _Batch(nodes, min_birth, retire_era)
        # Hand the batch to every thread whose interval may overlap it.  The
        # seal lock linearizes the snapshot against begin/end (the real
        # algorithm does this with a lock-free list splice; the distribution
        # -of-release-work semantics are identical).
        with self._seal_lock:
            holders = [
                t for t in self.all_ctxs()
                if t.active and t.lower <= retire_era and t.upper >= min_birth
                and t is not c  # own op releases at our end_op via inbox too
            ]
            # The sealing thread is inside an op and holds a reference itself.
            holders.append(c)
            batch.refs.store(len(holders))
            for t in holders:
                with t.inbox_lock:
                    t.inbox.append(batch)

    def _adopt(self, dead: ThreadCtx, adopter: ThreadCtx) -> None:
        # besides retired/pending, a dead thread must drop its references on
        # batches in its inbox (it can no longer release them at end_op)
        super()._adopt(dead, adopter)
        with dead.inbox_lock:
            batches, dead.inbox = dead.inbox, []
        for batch in batches:
            if batch.refs.add_fetch(-1) == 0:
                for node in batch.nodes:
                    self._free(adopter, node)

    def _release_inbox(self, c: ThreadCtx) -> None:
        with c.inbox_lock:
            batches, c.inbox = c.inbox, []
        for batch in batches:
            if batch.refs.add_fetch(-1) == 0:
                for node in batch.nodes:
                    self._free(c, node)

    def _on_end(self, c: ThreadCtx) -> None:
        self._release_inbox(c)

    def help_reclaim(self) -> None:
        """Self-only: seal own pending batch and release own inbox (both are
        this thread's state — safe under concurrency)."""
        c = self.ctx()
        self._seal(c, c.pending)
        c.pending = []
        self._release_inbox(c)

    # ------------------------------------------------------------- teardown
    def flush(self) -> None:
        """Teardown-only: seal EVERY thread's partial batch and drain every
        inbox.  Only call at quiescence (tests / engine shutdown)."""
        c = self.ctx()
        for t in self.all_ctxs():
            self._seal(c, t.pending)
            t.pending = []
        for t in self.all_ctxs():
            with t.inbox_lock:
                batches, t.inbox = t.inbox, []
            for batch in batches:
                if batch.refs.add_fetch(-1) == 0:
                    for node in batch.nodes:
                        self._free(c, node)
