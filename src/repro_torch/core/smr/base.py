"""Uniform SMR (safe memory reclamation) API — paper §2.2.

Every scheme exposes the same surface so data structures are written once:

* ``begin_op()/end_op()`` — operation scope (EBR-style schemes reserve here;
  HP-style schemes clear hazard slots in ``end_op``).  ``begin_op`` returns
  the thread's :class:`ThreadCtx`, and ``Guard.__enter__`` forwards it, so
  hot loops resolve thread-local state **once per operation** instead of
  once per pointer chase.
* ``protect(src, idx, ctx=None)`` — read a shared word and reserve its
  (unmarked) target under slot ``idx``.  HP validates by re-reading the
  source; era schemes publish/bump eras.  Returns the raw word (ref + mark
  bits).  Pass the ctx returned by the guard to skip the thread-local
  lookup.
* ``dup(src_idx, dst_idx, ctx=None)`` — duplicate a reservation to a higher
  slot index (paper §3.2: ascending order avoids the retire-scan race;
  cheaper than index renaming).  No-op for cumulative schemes (IBR,
  Hyaline-1S).
* ``retire(node, ctx=None)`` — node unlinked, hand to the scheme for
  eventual free.

``cumulative_protection`` is the property the paper's *recovery optimization*
dispatches on (§3.2.1): IBR/Hyaline-1S reservations are never cancelled by a
later ``protect``, so SCOT may fall back through a ring buffer of predecessors;
HP/HE get one-shot recovery only.

Hot-path bookkeeping is thread-local and amortized: slot clearing in
``end_op`` walks only up to the operation's high-water mark (``ctx.hwm``),
and retire-scan / era-tick triggers are plain countdown ints rather than
modulo arithmetic over shared counters.

Batching (DESIGN.md §4): ``guard_batch(k)`` opens ONE operation scope that
covers *k* logical operations — one ``ThreadCtx`` resolution, one
reservation lifecycle (one epoch publish for EBR, one interval for
IBR/Hyaline-1S, one slot-clear sweep for HP/HE) instead of k of each.
``retire_batch`` hands a whole unlinked chain to the scheme with a single
era read, a single coalesced era tick, and at most one retire scan.  The
cost side of the amortization: reservations live until the *batch* ends, so
a batch pins garbage for k operations' worth of time instead of one — the
DEBRA/Hyaline trade (bounded by the caller's batch size, not by stalls).
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

from ..atomics import (
    AtomicFlaggedRef,
    AtomicInt,
    AtomicMarkableRef,
    AtomicRef,
    SmrNode,
)

__all__ = ["ThreadCtx", "SmrScheme", "Guard", "BatchGuard"]


class ThreadCtx:
    """Globally visible per-thread reservation state (paper §2.2)."""

    __slots__ = (
        "thread",       # owning Thread; dead ⇒ ctx is reapable
        "slots",        # HP: node refs; HE: era ints
        "hwm",          # 1 + highest slot index written this op (clear bound)
        "lower",
        "upper",        # IBR / Hyaline-1S interval reservation
        "epoch",        # EBR entry-epoch reservation (None == quiescent)
        "active",
        "retired",      # local retired list
        "op_count",
        "scan_countdown",   # amortized retire-scan trigger
        "era_countdown",    # amortized era-clock advance trigger
        "pending",      # Hyaline: this thread's unsealed retired nodes
        "inbox",        # Hyaline: batches this thread must release
        "inbox_lock",
        "scratch",      # reusable scan buffers (hazard snapshot staging);
        "scratch2",     # owned by this thread's scans, cleared after use
        "scratch_set",
        # -- counters (thread-local, summed on demand; no contention) ------
        "n_retired",
        "n_reclaimed",
        "n_barriers",   # publishing stores (≈ memory fences on real HW)
        "n_scans",
    )

    def __init__(self, num_slots: int,
                 retire_scan_freq: int = 128, epoch_freq: int = 96):
        self.thread = threading.current_thread()
        self.slots: List[Optional[object]] = [None] * num_slots
        self.hwm = 0
        self.lower = 0
        self.upper = 0
        self.epoch: Optional[int] = None
        self.active = False
        self.retired: List[SmrNode] = []
        self.op_count = 0
        self.scan_countdown = retire_scan_freq
        self.era_countdown = epoch_freq
        self.pending: List[SmrNode] = []
        self.inbox: List[object] = []
        self.inbox_lock = threading.Lock()
        self.scratch: List = []
        self.scratch2: List = []
        self.scratch_set: set = set()
        self.n_retired = 0
        self.n_reclaimed = 0
        self.n_barriers = 0
        self.n_scans = 0


class Guard:
    """``with smr.guard() as ctx: ...`` — an operation scope.

    ``__enter__`` returns the resolved :class:`ThreadCtx` so the operation
    can pass it straight to ``protect``/``dup``/``retire`` and skip the
    per-call thread-local lookup.
    """

    __slots__ = ("_smr", "_ctx")

    def __init__(self, smr: "SmrScheme"):
        self._smr = smr
        self._ctx: Optional[ThreadCtx] = None

    def __enter__(self) -> ThreadCtx:
        self._ctx = c = self._smr.begin_op()
        return c

    def __exit__(self, *exc):
        self._smr.end_op(self._ctx)
        self._ctx = None
        return False


class BatchGuard(Guard):
    """``with smr.guard_batch(k) as ctx: ...`` — ONE operation scope shared
    by *k* logical operations (DESIGN.md §4).

    Exactly one ``begin_op``-equivalent on entry and one ``end_op`` on exit:
    the thread ctx is resolved once, the reservation lifecycle (epoch publish
    / interval / hazard-slot sweep) happens once, and ``op_count`` advances
    by k so throughput accounting still reflects logical operations.  All
    reservations taken inside the scope survive until the batch exits — the
    amortization trades k-times-longer garbage pinning for k-times-fewer
    scope transitions.
    """

    __slots__ = ("_n",)

    def __init__(self, smr: "SmrScheme", n: int = 1):
        super().__init__(smr)
        self._n = n

    def __enter__(self) -> ThreadCtx:
        self._ctx = c = self._smr.begin_batch(self._n)
        return c


class SmrScheme:
    """Base class; subclasses override the `_` hooks.

    Subclasses *declare capabilities* as class attributes; the
    :mod:`repro.api` registry reads them off the class so compatibility
    negotiation (which structures / traversal policies / batching modes a
    scheme legally supports) has a single source of truth here, instead of
    ``if scheme in (...)`` guards scattered over call sites.
    """

    name = "base"
    robust = False                 # bounded garbage with stalled threads?
    cumulative_protection = False  # protect() never cancels older reservations?
    reclaims = True                # ever frees memory? (NR: no — leak baseline)
    # Cross-operation resumed-traversal hints inside one batch scope
    # (DESIGN.md §4): "all" — hints may span levels/buckets freely (every
    # node observed in the scope stays protected); "flat" — only the flat
    # lists' single pinned-prev hint is legal (one-shot slot reservations).
    batch_hints = "flat"

    @classmethod
    def capabilities(cls) -> Dict[str, object]:
        """The scheme's capability declaration (registry source of truth)."""
        return {
            "name": cls.name,
            "robust": cls.robust,
            "cumulative_protection": cls.cumulative_protection,
            "reclaims": cls.reclaims,
            "batch_hints": cls.batch_hints,
        }

    def __init__(
        self,
        num_slots: int = 8,
        retire_scan_freq: int = 128,   # paper §5: amortize retire scans at 128
        epoch_freq: int = 96,          # paper §5: threads*12; fixed default
        free_fn: Optional[Callable[[SmrNode], None]] = None,
    ):
        self.num_slots = num_slots
        self.retire_scan_freq = retire_scan_freq
        self.epoch_freq = epoch_freq
        self._free_fn = free_fn
        # Thread idents are REUSED by the OS after a thread exits, so keying
        # by get_ident() would let a later thread overwrite a dead thread's
        # ctx and silently drop its retired/reclaimed counters (and any
        # garbage it still pins) from stats()/scans.  Instead the registry
        # holds ctx objects, and dead threads' ctxs are *reaped* on the next
        # ctx creation: their garbage is adopted by the new ctx, counters
        # fold into ``_reaped``, and the entry is removed — bounding the
        # registry by the number of live threads.
        self._ctxs: List[ThreadCtx] = []
        self._ctx_lock = threading.Lock()
        self._local = threading.local()
        self._reaped = {"retired": 0, "reclaimed": 0, "barriers": 0,
                        "scans": 0, "ops": 0}
        self.era = AtomicInt(1)  # global epoch/era clock (unused by NR/HP)

    # ------------------------------------------------------------------ ctx
    def ctx(self) -> ThreadCtx:
        c = getattr(self._local, "ctx", None)
        if c is None:
            c = ThreadCtx(self.num_slots,
                          self.retire_scan_freq, self.epoch_freq)
            with self._ctx_lock:
                dead = [t for t in self._ctxs if not t.thread.is_alive()]
                for t in dead:
                    # counters fold in the SAME critical section that
                    # removes the ctx, so stats()/not_yet_reclaimed() never
                    # see a window where the dead ctx is counted nowhere
                    # (which could report reclaimed > retired)
                    self._ctxs.remove(t)
                    r = self._reaped
                    r["retired"] += t.n_retired
                    r["reclaimed"] += t.n_reclaimed
                    r["barriers"] += t.n_barriers
                    r["scans"] += t.n_scans
                    r["ops"] += t.op_count
                    t.n_retired = t.n_reclaimed = 0
                    t.n_barriers = t.n_scans = t.op_count = 0
                self._ctxs.append(c)
            self._local.ctx = c
            # Adoption may free nodes (→ user free_fn → arbitrary locks), so
            # it happens OUTSIDE _ctx_lock; the dead ctxs are unreachable to
            # every other thread once removed from the registry.
            if dead:
                self._reap(dead, c)
        return c

    def _reap(self, dead: List[ThreadCtx], adopter: ThreadCtx) -> None:
        for t in dead:
            # a dead thread provably holds no references: cancel every
            # reservation so its garbage stops being pinned
            t.active = False
            t.epoch = None
            t.lower = t.upper = 0
            for i in range(len(t.slots)):
                t.slots[i] = None
            t.hwm = 0
            self._adopt(t, adopter)

    def _adopt(self, dead: ThreadCtx, adopter: ThreadCtx) -> None:
        """Move a dead thread's not-yet-reclaimed garbage to a live ctx so
        future scans can free it.  Reclaims credit to the adopter; retire
        credit stays with the (reaped) counters — totals stay consistent."""
        adopter.retired.extend(dead.retired)
        dead.retired = []
        adopter.pending.extend(dead.pending)
        dead.pending = []

    def all_ctxs(self) -> List[ThreadCtx]:
        with self._ctx_lock:
            return list(self._ctxs)

    def guard(self) -> Guard:
        return Guard(self)

    def guard_batch(self, n: int = 1) -> BatchGuard:
        """One operation scope amortized over ``n`` logical operations."""
        return BatchGuard(self, n)

    def scope(self, ctx: Optional[ThreadCtx],
              n: int = 1) -> ContextManager[ThreadCtx]:
        """Batch-entry-point helper: reuse the caller's already-open scope
        (``ctx`` is not None) or open a fresh ``guard_batch(n)``."""
        return nullcontext(ctx) if ctx is not None else self.guard_batch(n)

    # ----------------------------------------------------------- op scope
    def begin_op(self) -> ThreadCtx:
        return self.begin_batch(1)

    def begin_batch(self, n: int = 1) -> ThreadCtx:
        """Like :meth:`begin_op` but accounts ``n`` logical operations under
        the single reservation lifecycle (see :class:`BatchGuard`)."""
        c = self.ctx()
        c.active = True
        c.op_count += n
        self._on_begin(c)
        return c

    def end_op(self, ctx: Optional[ThreadCtx] = None) -> None:
        c = ctx if ctx is not None else self.ctx()
        self._on_end(c)
        c.active = False

    def _on_begin(self, c: ThreadCtx) -> None:  # pragma: no cover - overridden
        pass

    def _on_end(self, c: ThreadCtx) -> None:
        # HP-style default: drop the reservations this op actually wrote
        # (slots above the high-water mark are already None).
        hwm = c.hwm
        if hwm:
            slots = c.slots
            for i in range(hwm):
                slots[i] = None
            c.hwm = 0

    # ----------------------------------------------------------- protect
    # Default implementations are *plain loads* (NR / EBR); hazard- and
    # era-based schemes override `_reserve`.

    def protect(
        self, src: AtomicMarkableRef, idx: int,
        ctx: Optional[ThreadCtx] = None,
    ) -> Tuple[Optional[SmrNode], bool]:
        """Read (ref, mark) from ``src`` and reserve ``ref`` in slot ``idx``."""
        return self._reserve_markable(
            ctx if ctx is not None else self.ctx(), src, idx)

    def protect_ref(
        self, src: AtomicRef, idx: int,
        ctx: Optional[ThreadCtx] = None,
    ) -> Optional[SmrNode]:
        return self._reserve_plain(
            ctx if ctx is not None else self.ctx(), src, idx)

    def protect_edge(
        self, src: AtomicFlaggedRef, idx: int,
        ctx: Optional[ThreadCtx] = None,
    ) -> Tuple[Optional[SmrNode], bool, bool]:
        """NM-tree edge word: (ref, flag, tag)."""
        return self._reserve_flagged(
            ctx if ctx is not None else self.ctx(), src, idx)

    def _reserve_markable(self, c, src, idx):
        return src.get()

    def _reserve_plain(self, c, src, idx):
        return src.load()

    def _reserve_flagged(self, c, src, idx):
        return src.get()

    def dup(self, src_idx: int, dst_idx: int,
            ctx: Optional[ThreadCtx] = None) -> None:
        """Duplicate reservation src→dst.  Paper §3.2 requires src < dst."""
        assert src_idx < dst_idx, "dup must move to a higher slot index"
        # default: no-op (NR/EBR/IBR/HLN)

    def clear(self, idx: Optional[int] = None,
              ctx: Optional[ThreadCtx] = None) -> None:
        c = ctx if ctx is not None else self.ctx()
        if idx is None:
            for i in range(self.num_slots):
                c.slots[i] = None
            c.hwm = 0
        else:
            c.slots[idx] = None

    # ------------------------------------------------------------- retire
    def alloc_stamp(self, node: SmrNode) -> SmrNode:
        """Stamp birth era at allocation (HE/IBR/HLN); advance era clock."""
        node.birth_era = self.era.load()
        return node

    def retire(self, node: SmrNode,
               ctx: Optional[ThreadCtx] = None) -> None:
        assert node is not None
        if node._retired:  # double-retire is a data-structure bug
            raise AssertionError(f"double retire of node {node.node_id}")
        node._retired = True
        c = ctx if ctx is not None else self.ctx()
        c.n_retired += 1
        self._on_retire(c, node)

    def _on_retire(self, c: ThreadCtx, node: SmrNode) -> None:
        c.retired.append(node)
        self._maybe_scan(c)

    def retire_batch(self, nodes: List[SmrNode],
                     ctx: Optional[ThreadCtx] = None) -> None:
        """Retire a whole unlinked chain at once: one era read for the
        retire stamps, one coalesced era tick, at most one retire scan —
        instead of per-node clock traffic (DESIGN.md §4)."""
        if not nodes:
            return
        for node in nodes:
            assert node is not None
            if node._retired:  # double-retire is a data-structure bug
                raise AssertionError(f"double retire of node {node.node_id}")
            node._retired = True
        c = ctx if ctx is not None else self.ctx()
        c.n_retired += len(nodes)
        self._on_retire_batch(c, nodes)

    def _on_retire_batch(self, c: ThreadCtx, nodes: List[SmrNode]) -> None:
        # HP-style default: no era stamping, one countdown step per node but
        # a single scan trigger check for the whole chain.
        c.retired.extend(nodes)
        self._maybe_scan_n(c, len(nodes))

    def _maybe_scan(self, c: ThreadCtx) -> None:
        """Amortized retire-scan trigger (thread-local countdown)."""
        self._maybe_scan_n(c, 1)

    def _maybe_scan_n(self, c: ThreadCtx, n: int) -> None:
        """Coalesced countdown: n retirements, at most one scan."""
        c.scan_countdown -= n
        if c.scan_countdown <= 0:
            c.scan_countdown = self.retire_scan_freq
            self._scan(c)

    def _retire_stamped(self, c: ThreadCtx, node: SmrNode) -> None:
        """Shared ``_on_retire`` body for era-stamping schemes (EBR/HE/IBR)."""
        self._retire_stamped_batch(c, (node,))

    def _retire_stamped_batch(self, c: ThreadCtx, nodes: List[SmrNode]) -> None:
        """Batch body for era-stamping schemes: one clock read stamps the
        whole chain (all nodes were unlinked by the same CAS, so a shared
        retire era is exact, not an approximation), one coalesced era tick,
        at most one scan."""
        e = self.era.load()
        for node in nodes:
            node.retire_era = e
        c.retired.extend(nodes)
        self._tick_era_n(c, len(nodes))
        self._maybe_scan_n(c, len(nodes))

    def _scan(self, c: ThreadCtx) -> None:  # pragma: no cover - overridden
        pass

    def _free(self, c: ThreadCtx, node: SmrNode) -> None:
        c.n_reclaimed += 1
        if self._free_fn is not None:
            self._free_fn(node)
        else:
            node.poison()

    # maybe advance the global era/epoch clock (amortized, paper §5)
    def _tick_era(self, c: ThreadCtx) -> None:
        self._tick_era_n(c, 1)

    def _tick_era_n(self, c: ThreadCtx, n: int) -> None:
        """Coalesced era tick: n retirements advance the clock at most once
        (a chain unlinked by one CAS is one reclamation event, not n)."""
        c.era_countdown -= n
        if c.era_countdown <= 0:
            c.era_countdown = self.epoch_freq
            self.era.fetch_add(1)

    # -------------------------------------------------------------- stats
    def not_yet_reclaimed(self) -> int:
        with self._ctx_lock:
            base = self._reaped["retired"] - self._reaped["reclaimed"]
            cs = list(self._ctxs)
        return base + sum(c.n_retired - c.n_reclaimed for c in cs)

    def stats(self) -> Dict[str, int]:
        with self._ctx_lock:
            r = dict(self._reaped)
            cs = list(self._ctxs)
        retired = r["retired"] + sum(c.n_retired for c in cs)
        reclaimed = r["reclaimed"] + sum(c.n_reclaimed for c in cs)
        return {
            "retired": retired,
            "reclaimed": reclaimed,
            "not_yet_reclaimed": retired - reclaimed,
            "barriers": r["barriers"] + sum(c.n_barriers for c in cs),
            "scans": r["scans"] + sum(c.n_scans for c in cs),
            "ops": r["ops"] + sum(c.op_count for c in cs),
        }

    def flush(self) -> None:
        """Best-effort reclamation of everything reclaimable (test/teardown)."""
        for c in self.all_ctxs():
            self._scan(c)

    def help_reclaim(self) -> None:
        """Thread-safe, self-only reclamation assist (memory-pressure path:
        e.g. the serving engine when the page pool runs dry)."""
        self._scan(self.ctx())
