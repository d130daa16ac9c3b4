"""Harris-Michael lock-free list (Michael 2002) — the paper's baseline.

Logically deleted nodes are unlinked *immediately* on encounter, one CAS per
node, so physical removal always changes the incoming edge and plain HP
validation suffices (paper §2.4).  The costs SCOT removes: extra CAS traffic
under contention, and **no read-only search** (search may CAS too).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..atomics import AtomicInt, Recycler
from ..smr.base import SmrScheme
from .batched import BatchedListOps
from .node import ListNode
from .traversal import CarefulHM, TraversalPolicy, resolve_ctor_policy

HP_NEXT = 0
HP_CURR = 1
HP_PREV = 2

_RESTART = object()


class HarrisMichaelList(BatchedListOps):
    HP_SLOTS = 3
    # the careful traversal IS this structure — no other policy applies
    POLICIES = ("hm",)

    @classmethod
    def slots_needed(cls, policy: TraversalPolicy) -> int:
        return cls.HP_SLOTS

    def __init__(self, smr: SmrScheme, policy=None, recycle: bool = False):
        self.smr = smr
        self.policy = resolve_ctor_policy(type(self), smr,
                                          policy if policy is not None
                                          else CarefulHM())
        self.head = ListNode(float("-inf"))
        self.recycler = Recycler(ListNode) if recycle else None
        if recycle:
            smr._free_fn = self.recycler.free
        self.n_restarts = AtomicInt()
        self.n_cleanup_cas = AtomicInt()  # unlink CASes issued by traversals

    # ------------------------------------------------------------------ API
    def insert(self, key, value=None, ctx=None) -> bool:
        with self.smr.scope(ctx) as c:
            return self._insert_from(key, value, c)[0]

    def _insert_from(self, key, value, ctx, hint=None
                     ) -> Tuple[bool, ListNode]:
        smr = self.smr
        new = None
        while True:
            prev, curr, found = self._find(key, ctx=ctx, start=hint)
            hint = prev
            if found:
                return False, prev
            if new is None:
                if self.recycler is not None:
                    new = self.recycler.alloc(key, value)
                else:
                    new = ListNode(key, value)
                smr.alloc_stamp(new)
            new.next_ref().set(curr, False)
            if prev.next_ref().compare_exchange(curr, False, new, False):
                return True, prev

    def delete(self, key, ctx=None) -> bool:
        with self.smr.scope(ctx) as c:
            return self._delete_from(key, c)[0]

    def _delete_from(self, key, ctx, hint=None
                     ) -> Tuple[bool, ListNode, Optional[ListNode]]:
        smr = self.smr
        while True:
            prev, curr, found = self._find(key, ctx=ctx, start=hint)
            hint = prev
            if not found:
                return False, prev, None
            nxt, nmark = curr.next_ref().get()
            if nmark:
                continue
            if not curr.next_ref().compare_exchange(nxt, False, nxt, True):
                continue
            if prev.next_ref().compare_exchange(curr, False, nxt, False):
                smr.retire(curr, ctx)
            else:
                prev, _, _ = self._find(key, ctx=ctx,
                                        start=hint)  # help physical removal
            return True, prev, curr

    def search(self, key) -> bool:
        # NOT read-only: _find may unlink marked nodes (Michael's approach).
        with self.smr.guard() as ctx:
            _, _, found = self._find(key, ctx=ctx)
            return found

    contains = search

    # ----------------------------------------------------------- Michael find
    def _find(self, key, srch: bool = False, ctx=None, start=None
              ) -> Tuple[ListNode, Optional[ListNode], bool]:
        # `srch` accepted for API parity with HarrisList; Michael's find is
        # never read-only (it unlinks marked nodes even during search).
        if ctx is None:
            ctx = self.smr.ctx()
        while True:
            out = self._find_attempt(key, ctx, start)
            if out is not _RESTART:
                return out
            start = None  # restarts go back to the head
            self.n_restarts.fetch_add(1)

    def _find_attempt(self, key, ctx, start=None):
        smr = self.smr
        prev: ListNode = start if start is not None else self.head
        curr, smark = smr.protect(prev.next_ref(), HP_CURR, ctx)
        if smark and prev is not self.head:
            # resumed-from hint is logically deleted — resume proves nothing
            return _RESTART
        while True:
            if curr is None:
                return (prev, None, False)
            nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
            # re-validate the incoming edge (Michael's check): curr still
            # linked after we protected its next word
            if prev.next_ref().get() != (curr, False):
                return _RESTART
            if nmark:
                # immediate physical removal — the extra CAS SCOT avoids
                self.n_cleanup_cas.fetch_add(1)
                if not prev.next_ref().compare_exchange(curr, False, nxt, False):
                    return _RESTART
                smr.retire(curr, ctx)
                smr.dup(HP_NEXT, HP_CURR, ctx)
                curr = nxt
                continue
            if curr.key >= key:
                return (prev, curr, curr.key == key)
            smr.dup(HP_CURR, HP_PREV, ctx)
            prev = curr
            smr.dup(HP_NEXT, HP_CURR, ctx)
            curr = nxt

    # --------------------------------------------------------- debug utils
    def snapshot(self):
        out = []
        node = self.head.next_ref_unsafe().get_ref()
        while node is not None:
            nxt, mark = node.next_ref_unsafe().get()
            if not mark:
                out.append(node._key)
            node = nxt
        return out

    def stats(self):
        return {
            "restarts": self.n_restarts.load(),
            "cleanup_cas": self.n_cleanup_cas.load(),
        }
