"""Lock-free page free-list — the runtime eating the paper's dogfood.

The :class:`~repro.runtime.block_pool.BlockPool` used to serialize every
``alloc``/``free``/``reserve`` from N shard threads, the watchdog and the
swap paths on one ``threading.Lock``.  This module replaces that mutex with
the repo's own concurrency substrate: a Treiber-style stack of
:class:`FreeSlot` cells built on :class:`~repro.core.atomics.AtomicRef`,
reclaimed through a *negotiated* SMR scheme (VBR by default — any
``reclaims=True`` scheme works), plus a per-page atomic state table.

Linearization points (DESIGN.md §16):

* the **state table** (one :class:`AtomicInt` per page: FREE / ALLOCATED /
  RESERVED) is the ground truth — every transition is a single CAS on the
  page's own cell, and that CAS is the linearization point of
  ``alloc``/``free``/``reserve``/``unreserve``;
* the **stack** is a duplicate-tolerant bag of *hints*.  A pop hands back a
  candidate page id; the claim CAS (FREE→ALLOCATED) decides ownership, and
  a hint whose claim fails (the page was reserved or re-allocated through a
  newer hint) is simply discarded.  Every transition *to* FREE pushes a
  fresh cell, so no free page is ever hintless for long; ``alloc`` also
  carries a state-table sweep fallback for the transient window between a
  freeing thread's state CAS and its push.

SMR does the memory part: a popped cell is *retired*, not freed — a slow
thread that still holds the old head pointer reads its ``next`` field from
a cell that provably hasn't been recycled (the scheme pins it), which is
exactly the guarantee the paper's structures need and the pool mutex used
to fake.  Pushing needs **no** guard at all (it writes, never dereferences
shared cells), which is what makes the free path safe to run from *inside*
a scheme's retire scan — the route reclaimed ``PageNode`` ids take back to
the list.

The old mutex pool survives as :class:`LockedFreeList` (``pool_scheme=
"locked"``), upgraded from the seed's O(n) ``list.remove`` reserve to
set-based lazy deletion with O(1) membership.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..core.atomics import AtomicInt, AtomicRef, Recycler, SmrNode
from ..core.smr.base import SmrScheme

__all__ = ["FreeListEmpty", "FreeSlot", "LockFreeFreeList", "LockedFreeList"]

_FREE, _ALLOCATED, _RESERVED = 0, 1, 2


class FreeListEmpty(RuntimeError):
    """No page id is claimable right now (pool-level code maps this to
    :class:`~repro.runtime.block_pool.OutOfPagesError`)."""


class FreeSlot(SmrNode):
    """One stack cell: a hint that ``page_id`` *may* be free.  ``next`` is
    written before the publishing CAS and never mutated afterwards, so a
    reader that protected the cell can follow it without revalidation."""

    __slots__ = ("page_id", "next")

    def __init__(self, page_id: int = -1):
        super().__init__()
        self.page_id = page_id
        self.next: Optional["FreeSlot"] = None

    def reinit(self, page_id: int = -1):
        self.page_id = page_id
        self.next = None


class LockFreeFreeList:
    """Treiber stack + per-page state table under a negotiated SMR scheme.

    The scheme instance is *owned* by this list (its ``_free_fn`` routes
    reclaimed cells back to the cell recycler) and is deliberately separate
    from the scheme governing the pool's PageNodes: pushes happen inside
    that scheme's retire scans, and a dedicated domain means the push path
    can never re-enter — or widen — an open reservation of the caller.
    """

    kind = "lockfree"

    def __init__(self, num_pages: int, smr: SmrScheme):
        self.num_pages = num_pages
        self.smr = smr
        smr._free_fn = self._recycle_cell
        self._recycler = Recycler(FreeSlot)
        self._head: AtomicRef = AtomicRef(None)
        self._state = [AtomicInt(_FREE) for _ in range(num_pages)]
        self._n_free = AtomicInt(num_pages)
        self._n_reserved = AtomicInt(0)
        self.n_cas_retries = AtomicInt(0)   # head CAS lost to a racer
        self.n_stale_hints = AtomicInt(0)   # popped hint whose claim failed
        self.n_slow_claims = AtomicInt(0)   # state-sweep fallback allocs
        # chaos seam (serving/faults.py spirit): when set, called once per
        # alloc/free at a mid-operation point — HERE that point holds no
        # lock whatsoever (a stalled thread leaves one retired hint and
        # blocks nobody; the scheme bounds what its frozen reservation
        # pins).  Benchmarks and chaos tests use it to model a thread
        # descheduled inside a pool op.
        self._chaos_stall = None
        for pid in range(num_pages):
            self._push(pid)

    def _recycle_cell(self, node: SmrNode) -> None:
        self._recycler.free(node)

    # ------------------------------------------------------------- push
    def _push(self, pid: int) -> None:
        # No guard: allocates a fresh (or recycled-quiescent) cell, writes
        # next from a head snapshot, CAS-publishes.  Never dereferences a
        # shared cell, so it is legal from inside any scheme's retire scan.
        cell = self._recycler.alloc(pid)
        self.smr.alloc_stamp(cell)
        head = self._head
        while True:
            h = head.load()
            cell.next = h
            if head.compare_exchange(h, cell):
                return
            self.n_cas_retries.fetch_add(1)

    # ------------------------------------------------------------ alloc
    def alloc(self) -> int:
        smr = self.smr
        head = self._head
        state = self._state
        # inlined guard (no Guard object on the page-alloc hot path)
        c = smr.begin_op()
        try:
            while True:
                top = smr.protect_ref(head, 0, c)
                if top is None:
                    pid = self._sweep_claim()
                    if pid is not None:
                        return pid
                    raise FreeListEmpty(
                        f"no free page among {self.num_pages}")
                nxt = top.next  # immutable post-publish; cell pinned by smr
                if not head.compare_exchange(top, nxt):
                    self.n_cas_retries.fetch_add(1)
                    continue
                pid = top.page_id
                smr.retire(top, c)
                if self._chaos_stall is not None:
                    self._chaos_stall()  # mid-op: holds a hint, no lock
                if state[pid].compare_exchange(_FREE, _ALLOCATED):
                    self._n_free.fetch_add(-1)
                    return pid
                self.n_stale_hints.fetch_add(1)
        finally:
            smr.end_op(c)

    def _sweep_claim(self) -> Optional[int]:
        """Stack-empty fallback: claim straight off the state table.  Covers
        the window between a freeing thread's FREE CAS and its push (and
        hints burned as stale by reserve/unreserve churn) — a page freed
        before this alloc began is always found.  The hint a lagging push
        later lands for an already-claimed pid is discarded as stale."""
        for pid, st in enumerate(self._state):
            if st.compare_exchange(_FREE, _ALLOCATED):
                self._n_free.fetch_add(-1)
                self.n_slow_claims.fetch_add(1)
                return pid
        return None

    # ------------------------------------------------------------- free
    def free(self, pid: int) -> None:
        if not self._state[pid].compare_exchange(_ALLOCATED, _FREE):
            if self._state[pid].load() == _RESERVED:
                raise ValueError(
                    f"page {pid} is reserved (unreserve it; cannot free)")
            raise ValueError(
                f"page {pid} is already free — double-free is a pool "
                f"protocol violation (every alloc must be freed exactly "
                f"once)")
        if self._chaos_stall is not None:
            self._chaos_stall()  # mid-op: page FREE but hint not yet pushed
        self._n_free.fetch_add(1)
        self._push(pid)

    # ----------------------------------------------------------- reserve
    def reserve(self, pid: int) -> None:
        # O(1): one CAS.  The page's stack hint is NOT hunted down — the
        # claim CAS in alloc() discards it lazily (satellite of ISSUE 9:
        # the seed did an O(n) list.remove here).
        if not (0 <= pid < self.num_pages) or \
                not self._state[pid].compare_exchange(_FREE, _RESERVED):
            raise ValueError(f"page {pid} is not free (cannot reserve)")
        self._n_free.fetch_add(-1)
        self._n_reserved.fetch_add(1)

    def unreserve(self, pid: int) -> None:
        if not (0 <= pid < self.num_pages) or \
                not self._state[pid].compare_exchange(_RESERVED, _FREE):
            raise ValueError(f"page {pid} is not reserved (cannot unreserve)")
        self._n_reserved.fetch_add(-1)
        self._n_free.fetch_add(1)
        self._push(pid)

    # ------------------------------------------------------------- stats
    def free_count(self) -> int:
        return self._n_free.load()

    def reserved_count(self) -> int:
        return self._n_reserved.load()

    def stats(self) -> dict:
        return {
            "pool_cas_retries": self.n_cas_retries.load(),
            "pool_stale_hints": self.n_stale_hints.load(),
            "pool_slow_claims": self.n_slow_claims.load(),
        }


class LockedFreeList:
    """The seed's mutex pool, kept as the ``pool_scheme="locked"`` fallback
    — with the O(n) ``list.remove`` reserve replaced by set-based lazy
    deletion (O(1) membership; stale stack entries are skipped at pop)."""

    kind = "locked"
    smr = None

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._lock = threading.Lock()
        self._stack: List[int] = list(range(num_pages))
        self._free_set = set(self._stack)
        self._reserved = set()
        # chaos seam, mirror of LockFreeFreeList._chaos_stall — but here the
        # mid-operation point is necessarily INSIDE the critical section
        # (the whole op body holds the mutex), so a stalled thread convoys
        # every other pool caller for the duration.  That asymmetry is the
        # measurement, not an artifact (benchmarks/bench_pool.py).
        self._chaos_stall = None

    def alloc(self) -> int:
        with self._lock:
            if self._chaos_stall is not None:
                self._chaos_stall()  # mid-op: the mutex is held
            stack = self._stack
            free_set = self._free_set
            while stack:
                pid = stack.pop()
                if pid in free_set:  # skip lazily-deleted (reserved) entries
                    free_set.discard(pid)
                    return pid
            raise FreeListEmpty(f"no free page among {self.num_pages}")

    def free(self, pid: int) -> None:
        with self._lock:
            if self._chaos_stall is not None:
                self._chaos_stall()  # mid-op: the mutex is held
            if pid in self._free_set:
                raise ValueError(
                    f"page {pid} is already free — double-free is a pool "
                    f"protocol violation (every alloc must be freed exactly "
                    f"once)")
            if pid in self._reserved:
                raise ValueError(
                    f"page {pid} is reserved (unreserve it; cannot free)")
            self._free_set.add(pid)
            self._stack.append(pid)

    def reserve(self, pid: int) -> None:
        with self._lock:
            if pid not in self._free_set:
                raise ValueError(f"page {pid} is not free (cannot reserve)")
            self._free_set.discard(pid)  # stack entry skipped lazily: O(1)
            self._reserved.add(pid)

    def unreserve(self, pid: int) -> None:
        with self._lock:
            if pid not in self._reserved:
                raise ValueError(
                    f"page {pid} is not reserved (cannot unreserve)")
            self._reserved.discard(pid)
            self._free_set.add(pid)
            self._stack.append(pid)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free_set)

    def reserved_count(self) -> int:
        with self._lock:
            return len(self._reserved)

    def stats(self) -> dict:
        return {}
