"""Fraser-style lock-free skip list with SCOT optimistic traversals.

The paper (§3.4, Table 1) notes Fraser's skip list has *exactly* the Harris
optimistic-traversal structure per level, so SCOT applies verbatim level-wise:
each level is traversed with the dangerous-zone validation of
``harris_list.py``.  The paper does not evaluate skip lists ("Harris' vs
Harris-Michael lists ... capture the differences already"); we provide the
structure for completeness with the same SMR-safety discipline.

Deletion protocol: logical delete marks the tower's next pointers top-down
(level-0 mark is the linearization point).  Physical unlink happens per level
by traversals (Harris one-CAS chain removal).  The level-0 marker *owns*
retirement: it re-traverses all levels until the node is unlinked everywhere
and no insert is mid-way through linking upper levels (``link_pending``),
then retires the tower exactly once.
"""

from __future__ import annotations

import random
import threading
from typing import List, Optional, Tuple

from ..atomics import AtomicInt
from ..smr.base import SmrScheme
from .node import TowerNode
from .traversal import UNSET, TraversalPolicy, resolve_ctor_policy

HP_NEXT = 0
HP_CURR = 1
HP_PREV = 2
HP_UNSAFE = 3

_RESTART = object()


class SkipList:
    HP_SLOTS = 4
    # per-level Harris traversals: plain or SCOT-validated.  No wait-free
    # variant — the level-0 deletion owner's unlink loop is where the
    # structure's progress argument lives, not the traversal.
    POLICIES = ("optimistic", "scot")

    @classmethod
    def slots_needed(cls, policy: TraversalPolicy) -> int:
        return cls.HP_SLOTS

    def __init__(self, smr: SmrScheme, max_height: int = 12,
                 policy=None, *, scot=UNSET, seed: Optional[int] = None):
        self.smr = smr
        self.policy = p = resolve_ctor_policy(type(self), smr, policy,
                                              scot=scot)
        self.scot = p.validates
        self.max_height = max_height
        self.head = TowerNode(float("-inf"), max_height)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.n_restarts = AtomicInt()

    def _random_height(self) -> int:
        with self._rng_lock:
            h = 1
            while h < self.max_height and self._rng.random() < 0.5:
                h += 1
            return h

    # ------------------------------------------------------------------ API
    def insert(self, key, value=None) -> bool:
        with self.smr.guard() as ctx:
            return self._insert(key, value, ctx)

    def _insert(self, key, value, ctx) -> bool:
        smr = self.smr
        height = self._random_height()
        node = TowerNode(key, height, value)
        smr.alloc_stamp(node)
        # link_pending is raised BEFORE the node becomes reachable so the
        # deletion owner can never retire a tower with an in-flight link.
        node.link_pending.fetch_add(1)
        try:
            while True:
                prev, curr, found = self._find_level(key, 0, srch=False,
                                                     ctx=ctx)
                if found:
                    return False
                if curr is not None and curr.key == key:
                    # equal-key tower that got marked between the
                    # traversal's protect and the found-recheck: linking
                    # in FRONT of it would hide it from its deleter's
                    # `curr is node` check in _unlink_all, which would
                    # then retire it while still physically linked (a
                    # use-after-free for later traversals).  Re-find —
                    # the retry's own traversal unlinks the dying tower.
                    continue
                node.next_ref(0).set(curr, False)  # unpublished yet: plain set
                if prev.next_ref(0).compare_exchange(curr, False,
                                                     node, False):
                    break
            # link upper levels; node's own next pointers are updated via
            # CAS-from-unmarked so a concurrent delete's mark is never lost
            aborted = False
            for lvl in range(1, height):
                while True:
                    if node.next_ref(0).get_mark():
                        aborted = True
                        break
                    prev, curr, _ = self._find_level(key, lvl,
                                                     srch=False, ctx=ctx)
                    if curr is not None and curr is not node \
                            and curr.key == key:
                        continue  # dying equal-key tower at this level:
                        # never link in front of it (see level-0 note)
                    old, omark = node.next_ref(lvl).get()
                    if omark:
                        aborted = True
                        break
                    if not node.next_ref(lvl).compare_exchange(
                            old, False, curr, False):
                        aborted = True  # marked under us
                        break
                    if curr is node:  # defensive
                        break
                    if prev.next_ref(lvl).compare_exchange(
                            curr, False, node, False):
                        break
                if aborted:
                    break
            # repair: if we were marked while linking, help unlink any
            # levels we may have extended after the mark
            if node.next_ref(0).get_mark():
                for lvl in range(height - 1, -1, -1):
                    self._find_level(key, lvl, srch=False, ctx=ctx)
        finally:
            node.link_pending.fetch_add(-1)
        return True

    def delete(self, key) -> bool:
        with self.smr.guard() as ctx:
            return self._delete(key, ctx)

    def _delete(self, key, ctx) -> bool:
        while True:
            prev, curr, found = self._find_level(key, 0, srch=False,
                                                 ctx=ctx)
            if not found:
                return False
            node = curr
            # mark top-down; marking level 0 linearizes the delete and
            # makes us the *owner* who retires
            for lvl in range(node.height - 1, 0, -1):
                while True:
                    nxt, mark = node.next_ref(lvl).get()
                    if mark:
                        break
                    if node.next_ref(lvl).compare_exchange(
                            nxt, False, nxt, True):
                        break
            nxt, mark = node.next_ref(0).get()
            if mark:
                continue  # somebody else owns the deletion; retry find
            if not node.next_ref(0).compare_exchange(nxt, False, nxt, True):
                continue
            # we own it: unlink everywhere, then retire exactly once
            self._unlink_all(key, node, ctx)
            return True

    def search(self, key) -> bool:
        with self.smr.guard() as ctx:
            return self._search(key, ctx)

    def _search(self, key, ctx) -> bool:
        lvl = self.max_height - 1
        prev = self.head
        while lvl > 0:
            prev, _, found = self._find_level(key, lvl, srch=True,
                                              start=prev, ctx=ctx)
            if found:
                return True
            lvl -= 1
        _, _, found = self._find_level(key, 0, srch=True, start=prev,
                                       ctx=ctx)
        return found

    contains = search

    # ------------------------------------------------------------ batched
    def search_many(self, keys, ctx=None):
        """Membership for many keys under ONE guard scope (DESIGN.md §4).

        Under *cumulative* schemes (EBR/IBR/HLN/NR) the sorted batch resumes
        each level's traversal from the previous key's predecessor — every
        node observed inside the scope stays protected until the scope ends,
        so the carried-over hints are dereferenceable (a marked hint makes
        ``_find_level`` restart from the head).  Under one-shot schemes
        (HP/HE) only slot-resident nodes are protected and a tower search
        recycles its slots level by level, so stale cross-key hints could
        dangle — those schemes do a per-key descent and amortize only the
        guard."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._search_many(keys, out, c)
        return out

    def _search_many(self, keys, out, ctx) -> None:
        order = sorted(range(len(keys)), key=keys.__getitem__)
        if not self.smr.cumulative_protection:
            for i in order:
                out[i] = self._search(keys[i], ctx)
            return
        top = self.max_height - 1
        hints = [self.head] * self.max_height
        for i in order:
            key = keys[i]
            prev = hints[top]
            found = False
            for lvl in range(top, -1, -1):
                # resume from the further-along of (this level's hint, the
                # predecessor carried down from the level above) — both are
                # <= key and both stay protected for the whole batch scope
                start = hints[lvl]
                if prev is not self.head and (start is self.head
                                              or start.key < prev.key):
                    start = prev
                prev, _, found = self._find_level(key, lvl, srch=True,
                                                  start=start, ctx=ctx)
                hints[lvl] = prev
                if found:
                    break
            out[i] = found

    def insert_many(self, keys, values=None, ctx=None):
        """Insert many keys under ONE guard scope (sorted application;
        results aligned with the input order)."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        order = sorted(range(len(keys)), key=keys.__getitem__)
        with self.smr.scope(ctx, len(keys)) as c:
            for i in order:
                v = values[i] if values is not None else None
                out[i] = self._insert(keys[i], v, c)
        return out

    def delete_many(self, keys, ctx=None):
        """Delete many keys under ONE guard scope."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        order = sorted(range(len(keys)), key=keys.__getitem__)
        with self.smr.scope(ctx, len(keys)) as c:
            for i in order:
                out[i] = self._delete(keys[i], c)
        return out

    # --------------------------------------------------------------- internals
    def _unlink_all(self, key, node: TowerNode, ctx=None) -> None:
        smr = self.smr
        while True:
            present = False
            for lvl in range(node.height - 1, -1, -1):
                _, curr, found_at = self._find_level(key, lvl, srch=False,
                                                     ctx=ctx)
                if curr is node:
                    present = True
            if not present and node.link_pending.load() == 0:
                break
        smr.retire(node, ctx)

    def _find_level(self, key, lvl: int, srch: bool,
                    start: Optional[TowerNode] = None, ctx=None
                    ) -> Tuple[TowerNode, Optional[TowerNode], bool]:
        """Harris find restricted to one level, with SCOT validation."""
        if ctx is None:
            ctx = self.smr.ctx()
        while True:
            out = self._find_level_attempt(key, lvl, srch, start, ctx)
            if out is not _RESTART:
                return out
            self.n_restarts.fetch_add(1)
            start = None  # restarts go back to the head

    def _find_level_attempt(self, key, lvl, srch, start, ctx):
        smr = self.smr
        prev: TowerNode = start if start is not None else self.head
        curr, smark = smr.protect(prev.next_ref(lvl), HP_CURR, ctx)
        if smark and prev is not self.head:
            # The start node carried over from the upper level has been
            # logically deleted: it may already sit inside an unlinked
            # chain, so the edge out of it proves nothing about `curr`
            # (dereferencing would be the Figure-1 bug).  Restart from the
            # head — the retry path resets start=None.
            return _RESTART
        prev_next = curr
        while True:
            # phase 1 — safe zone
            while True:
                if curr is None:
                    return self._finish_level(prev, prev_next, None, srch,
                                              key, lvl)
                nxt, nmark = smr.protect(curr.next_ref(lvl), HP_NEXT, ctx)
                if nmark:
                    break
                if curr.key >= key:
                    return self._finish_level(prev, prev_next, curr, srch,
                                              key, lvl)
                smr.dup(HP_CURR, HP_PREV, ctx)
                prev = curr
                prev_next = nxt
                smr.dup(HP_NEXT, HP_CURR, ctx)
                curr = nxt
            # phase 2 — dangerous zone
            if self.scot:
                smr.dup(HP_CURR, HP_UNSAFE, ctx)
            chain_start = curr
            while True:
                curr = nxt
                if curr is None:
                    return self._finish_level(prev, chain_start, None, srch,
                                              key, lvl)
                smr.dup(HP_NEXT, HP_CURR, ctx)
                # validate BEFORE dereferencing the reserved node (Thm 1)
                if self.scot and prev.next_ref(lvl).get() != (chain_start, False):
                    return _RESTART
                nxt, nmark = smr.protect(curr.next_ref(lvl), HP_NEXT, ctx)
                if not nmark:
                    break
            if curr.key >= key:
                return self._finish_level(prev, chain_start, curr, srch,
                                          key, lvl)
            smr.dup(HP_CURR, HP_PREV, ctx)
            prev = curr
            smr.dup(HP_NEXT, HP_CURR, ctx)   # pin nxt before Phase 1
            # overwrites Hp0 (see harris_list.py — same slot-shift rule)
            prev_next = nxt
            curr = nxt

    def _finish_level(self, prev, prev_next, curr, srch, key, lvl):
        if not srch and prev_next is not curr:
            if not prev.next_ref(lvl).compare_exchange(prev_next, False,
                                                       curr, False):
                return _RESTART
            # NOTE: unlike the flat list, the unlinker does NOT retire here —
            # towers are retired once by the level-0 deletion owner.
        found = curr is not None and curr.key == key and \
            not curr.next_ref(lvl).get_mark()
        return (prev, curr, found)

    def snapshot(self):
        out = []
        node = self.head.next_ref_unsafe(0).get_ref()
        while node is not None:
            nxt, mark = node.next_ref_unsafe(0).get()
            if not mark:
                out.append(node._key)
            node = nxt
        return out
