"""SMR-managed KV page pool — the paper's technique as a serving feature.

Pages of the paged KV cache are represented by :class:`PageNode`s whose
lifecycle is governed by a pluggable SMR scheme (EBR/HP/HE/IBR/Hyaline-1S):

* a page is *retired* when its owning sequence completes (and it is not
  pinned by the prefix cache);
* the page id returns to the free list only when no concurrent scheduler /
  worker thread still holds a protected reference — the exact guarantee SCOT
  traversals need when they walk prefix-cache entries that reference pages.

Robustness (paper property A) translates directly: with HP/HE/IBR/HLN, a
*stalled* worker thread can only pin O(K) pages — the pool cannot leak; with
EBR a stalled worker pins every page retired after its stall
(tests/test_block_pool.py demonstrates both).

PageNodes are recycled through :class:`Recycler` (same object identity), so
the ABA scenario — a page freed and re-allocated to a different sequence
while a stale reference exists — is physically exercisable, and prevented by
the SMR protections.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..core.atomics import AtomicInt, Recycler, SmrNode
from ..core.smr import SCHEMES
from ..core.smr.base import SmrScheme
from .free_list import FreeListEmpty, LockFreeFreeList, LockedFreeList


class PageNode(SmrNode):
    """A physical KV page.  ``page_id`` indexes the device-side page pool
    (k_pages/v_pages arrays consumed by the paged-attention kernel)."""

    __slots__ = ("page_id", "pin_count", "seq_id", "owner", "_plock")

    def __init__(self, page_id: int):
        super().__init__()
        self.page_id = page_id
        self.pin_count = AtomicInt(0)   # prefix-cache pins
        self.seq_id: Optional[int] = None
        self.owner: Optional["BlockPool"] = None
        self._plock = threading.Lock()  # linearizes pin/retire decisions

    def reinit(self, page_id: int):
        self.page_id = page_id
        self.pin_count = AtomicInt(0)   # fresh object: stale unpins are inert
        self.seq_id = None
        self.owner = None
        # _plock is deliberately REUSED across incarnations: a stale holder
        # still serializes against the new lifetime (swapping the lock object
        # would let old and new holders interleave), and recycling skips a
        # Lock allocation per page churn.


def _reclaim_dispatch(node) -> None:
    """Scheme-level free hook that routes each freed node to the pool that
    owns it — several :class:`BlockPool`\\ s (e.g. shards in ``shared`` SMR
    mode) and the index structures can all share ONE scheme instance without
    the last-constructed pool capturing everyone's frees."""
    owner = getattr(node, "owner", None)
    if owner is not None:
        owner._reclaim(node)
    else:
        node.poison()  # index nodes (lists/trees) just get poisoned


class OutOfPagesError(RuntimeError):
    pass


def _make_free_list(num_pages: int, pool_scheme: str):
    """Negotiate the free-list engine from ``pool_scheme``.

    ``"locked"`` is the mutex fallback; any other name must be a registered
    SMR scheme that actually reclaims (``reclaims=True``) — the free list
    retires a stack cell per pop, and a never-reclaiming scheme (NR) would
    leak a cell per alloc.  The scheme instance is dedicated to the list
    (small slot count, eager scan) so its reservations never interact with
    the caller's open guards."""
    if pool_scheme == "locked":
        return LockedFreeList(num_pages)
    cls = SCHEMES.get(pool_scheme.upper())
    if cls is None:
        raise ValueError(
            f"unknown pool_scheme {pool_scheme!r}: choose a reclaiming SMR "
            f"scheme ({sorted(SCHEMES)}) or 'locked'")
    if not cls.reclaims:
        raise ValueError(
            f"pool_scheme {cls.name!r} never reclaims (reclaims=False) — "
            f"free-list cells would leak one per alloc; choose a "
            f"reclaims=True scheme (api.schemes(reclaims=True)) or 'locked'")
    smr = cls(num_slots=2, retire_scan_freq=32, epoch_freq=32)
    return LockFreeFreeList(num_pages, smr)


class BlockPool:
    """Free-list + SMR-deferred reuse of KV pages.

    ``pool_scheme`` picks the free-list engine (DESIGN.md §16): any
    ``reclaims=True`` SMR scheme name builds a :class:`LockFreeFreeList`
    under a dedicated instance of that scheme (default ``"VBR"`` — alloc/
    free/reserve never take a mutex), while ``"locked"`` keeps the seed's
    mutex list (with O(1) set-based reserve).  The scheme governing the
    *pages* (``smr``) is independent of — and unchanged by — this choice.
    """

    def __init__(self, smr: SmrScheme, num_pages: int,
                 pool_scheme: str = "VBR"):
        self.smr = smr
        self.num_pages = num_pages
        self._free = _make_free_list(num_pages, pool_scheme)
        self.pool_scheme = "locked" if pool_scheme == "locked" \
            else pool_scheme.upper()
        self._recycler = Recycler(PageNode)
        # reclamation path: when the SMR scheme frees a PageNode, its id
        # returns to the free list (of the pool that owns it — the dispatch
        # keeps a shared scheme instance safe across several pools) and the
        # node object is recycled
        smr._free_fn = _reclaim_dispatch
        self.n_alloc = AtomicInt(0)
        self.n_retired = AtomicInt(0)
        self.n_reclaimed = AtomicInt(0)
        # cross-domain sequence handoffs (live migration, DESIGN.md §14)
        self.n_handoff_in = AtomicInt(0)
        self.n_handoff_out = AtomicInt(0)

    # ------------------------------------------------------------ alloc
    def alloc(self, seq_id: Optional[int] = None) -> PageNode:
        try:
            pid = self._free.alloc()
        except FreeListEmpty:
            raise OutOfPagesError(
                f"pool exhausted ({self.num_pages} pages; "
                f"{self.smr.not_yet_reclaimed()} awaiting reclamation)"
            ) from None
        node = self._recycler.alloc(pid)
        node.owner = self
        self.smr.alloc_stamp(node)
        node.seq_id = seq_id
        self.n_alloc.fetch_add(1)
        return node

    def reserve(self, page_id: int) -> int:
        """Take ``page_id`` out of circulation (e.g. the engine's scratch
        page that padded batch rows write to).  The id never becomes a
        :class:`PageNode`, is excluded from ``free``/accounting, and comes
        back via :meth:`unreserve`.  Raises ``ValueError`` if the id is not
        currently free.  O(1): a state-table CAS on the lock-free path, a
        set membership check on the locked fallback — never a scan of the
        free list."""
        self._free.reserve(page_id)
        return page_id

    def unreserve(self, page_id: int) -> None:
        """Return a :meth:`reserve`-d id to the free list."""
        self._free.unreserve(page_id)

    def try_alloc(self, seq_id: Optional[int] = None) -> Optional[PageNode]:
        try:
            return self.alloc(seq_id)
        except OutOfPagesError:
            return None

    # ------------------------------------------------------------ retire
    def release(self, page: PageNode) -> None:
        """Sequence done with the page.  If the prefix cache still pins it,
        the *unpin* path retires instead (exactly-once via _plock)."""
        self.n_retired.fetch_add(1)
        with page._plock:
            page.seq_id = None
            if page.pin_count.load() == 0 and not page._retired:
                self.smr.retire(page)

    def pin(self, page: PageNode) -> None:
        """Unconditional pin.  Callers that may race with eviction must
        validate the referencing index entry afterwards (SCOT-style: pin,
        then re-check the entry is still unmarked) and unpin on failure —
        a transient pin on a recycled page is inert (reinit swaps the
        counter object)."""
        page.pin_count.fetch_add(1)

    def unpin(self, page: PageNode) -> None:
        with page._plock:
            if page.pin_count.add_fetch(-1) == 0 and page.seq_id is None \
                    and not page._retired and not page.is_freed:
                self.smr.retire(page)

    # ------------------------------------------------- cross-domain handoff
    def import_claim(self, pages: List[PageNode]) -> None:
        """Target side of an SMR-safe cross-domain sequence handoff
        (DESIGN.md §14).  ``pages`` are THIS pool's pages, already pinned
        for the migrating sequence (the prefix-cache lookup pinned them);
        this records the adoption.  Must happen BEFORE the source pool's
        :meth:`export_claim` — between the two calls both domains pin the
        sequence's pages, so there is no window where neither does.

        The ordering is VALIDATED, not assumed: every page must belong to
        this pool and carry a live pin.  A foreign page means the handoff
        mixed up domains (a PageNode never leaves its pool — adopting one
        would let this domain's reclamation race the real owner's); a
        zero pin means the target-pins-first step was skipped and the
        source's retire could reclaim the page mid-handoff.  Both are
        protocol violations that used to pass silently."""
        for pg in pages:
            if pg.owner is not self:
                owner_id = id(pg.owner) if pg.owner is not None else None
                raise ValueError(
                    f"import_claim: page {pg.page_id} belongs to pool "
                    f"{owner_id} (not this pool {id(self)}) — a handoff "
                    f"must pin the TARGET domain's own pages (PageNodes "
                    f"never cross pools)")
            if pg.pin_count.load() <= 0:
                raise ValueError(
                    f"import_claim: page {pg.page_id} has pin_count="
                    f"{pg.pin_count.load()} — the target must pin before "
                    f"the source retires (import-before-export), else the "
                    f"page can be reclaimed mid-handoff")
        self.n_handoff_in.fetch_add(1)

    def export_claim(self, hit_pages: List[PageNode],
                     owned_pages: List[PageNode]) -> None:
        """Source side of the handoff: retire THIS domain's claim on a
        migrated sequence — owned pages released, admission hit pins
        dropped.  Safe to run from the watchdog thread: retire defers to
        this pool's own SMR scheme, and a PageNode never leaves its pool,
        so the target domain's pins (taken first, on the target's own
        nodes) are invisible to — and untouchable by — this reclamation."""
        for pg in owned_pages:
            self.release(pg)
        for pg in hit_pages:
            self.unpin(pg)
        self.n_handoff_out.fetch_add(1)

    def _reclaim(self, node: PageNode) -> None:
        # one SMR instance governs pages AND the index structures that
        # reference them (prefix-cache list nodes); only pages route here
        # (via _reclaim_dispatch — index nodes carry no ``owner``)
        pid = node.page_id
        self.n_reclaimed.fetch_add(1)
        self._recycler.free(node)  # poisons; resurrected on next alloc
        # Raises ValueError on a double-free: a page id returning to the
        # list while already free means two retires raced for one alloc —
        # a protocol violation, surfaced instead of silently duplicating
        # the id (mirror of the import_claim hardening).
        self._free.free(pid)

    # ------------------------------------------------------------- stats
    def free_count(self) -> int:
        return self._free.free_count()

    def stats(self):
        stats = {
            "pool_scheme": self.pool_scheme,
            "free": self._free.free_count(),
            "reserved": self._free.reserved_count(),
            "alloc": self.n_alloc.load(),
            "retired": self.n_retired.load(),
            "reclaimed": self.n_reclaimed.load(),
            "awaiting_reclaim": self.smr.not_yet_reclaimed(),
            "handoff_in": self.n_handoff_in.load(),
            "handoff_out": self.n_handoff_out.load(),
        }
        stats.update(self._free.stats())
        return stats
