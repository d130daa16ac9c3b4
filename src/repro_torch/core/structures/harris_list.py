"""Harris' lock-free linked list with **SCOT** optimistic traversals.

Faithful implementation of the paper's Figure 4 (SCOT `Do_Find`) on top of the
uniform SMR API, plus the §3.2.1 recovery optimization:

* hazard slot layout (paper L42-45)::

      Hp0 — next        Hp1 — curr
      Hp2 — last safe node (prev)       Hp3 — first unsafe node

* two-phase traversal: Phase 1 iterates the *safe zone* (unmarked nodes,
  Harris-Michael-style slot shifting); on meeting a logically deleted node the
  traversal duplicates ``Hp1→Hp3`` once and enters the *dangerous zone*,
  where after each ``protect`` it validates that the last safe node still
  points at the first unsafe node (``*prev == prev_next``).  Chains are only
  unlinked from their head (ordered node removal, Lemma 1), so this single
  check proves every chain node up to ``curr`` is still physically linked —
  hence unreclaimed (Theorem 1).

* recovery (§3.2.1): on validation failure, if the last safe node is itself
  still unmarked, escape the dangerous zone and resume from it (one-shot —
  all schemes).  If it was deleted: schemes with *cumulative* protection
  (IBR, Hyaline-1S) fall back through a ring buffer of up to
  ``recovery_depth`` predecessors (Figure 6); HP/HE must restart from the
  head (extra hazard slots would cost barriers).

The traversal strategy is a pluggable :class:`~.traversal.TraversalPolicy`
(``policy="optimistic" | "scot" | "waitfree"``): ``optimistic`` reproduces
the **pre-paper buggy behaviour** (no validation) so tests can demonstrate
Figure 1's use-after-free — the shim raises :class:`UseAfterFreeError`
where real hardware would SEGFAULT; ``waitfree`` adds the paper's §4
wait-free modification (anchor slot Hp4 + careful escalation, DESIGN.md
§10).  The legacy ``scot=``/``recovery=`` booleans still map onto policies
for one release (deprecated).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..atomics import AtomicInt, Recycler, UseAfterFreeError
from ..smr.base import SmrScheme
from .batched import BatchedListOps
from .node import ListNode
from .traversal import UNSET, TraversalPolicy, resolve_ctor_policy

HP_NEXT = 0   # Hp0
HP_CURR = 1   # Hp1
HP_PREV = 2   # Hp2 — last safe node
HP_UNSAFE = 3  # Hp3 — first unsafe node (SCOT's extra slot)
HP_ANCHOR = 4  # Hp4 — trailing safe node (wait-free policy only, §4)

_RESTART = object()  # sentinel: full restart requested


class HarrisList(BatchedListOps):
    """Lock-free ordered set with optimistic (read-only) search.

    Batched entry points (``search_many``/``insert_many``/``delete_many``/
    ``get_node``/``get_nodes``/``pop``) come from :class:`BatchedListOps`;
    this class supplies the resumable ``_find`` and the single-op bodies
    (``_insert_from``/``_delete_from``) they are built from."""

    HP_SLOTS = 4
    POLICIES = ("optimistic", "scot", "waitfree")

    @classmethod
    def slots_needed(cls, policy: TraversalPolicy) -> int:
        return cls.HP_SLOTS + policy.extra_list_slots

    def __init__(
        self,
        smr: SmrScheme,
        policy=None,
        *,
        scot=UNSET,
        recovery=UNSET,
        recovery_depth=UNSET,   # paper §3.2.1: ring of 8 is ~optimal
        recycle: bool = False,
    ):
        self.smr = smr
        # Default policy = the paper's rule: SCOT exactly under the robust
        # schemes (HP/HE/IBR/HLN); NR/EBR traverse safely without validation.
        self.policy = p = resolve_ctor_policy(
            type(self), smr, policy,
            scot=scot, recovery=recovery, recovery_depth=recovery_depth)
        self.scot = p.validates
        self.recovery = p.recovery
        self.recovery_depth = p.recovery_depth
        self.wait_free = p.wait_free
        self.head = ListNode(float("-inf"))  # sentinel, never retired
        self.recycler = Recycler(ListNode) if recycle else None
        if recycle:
            # route scheme frees through the recycler so ABA is exercisable
            smr._free_fn = self.recycler.free
        # mechanism counters (paper-relevant: restarts ⇒ lock-freedom argument)
        self.n_restarts = AtomicInt()
        self.n_recoveries = AtomicInt()
        self.n_ring_recoveries = AtomicInt()
        self.n_validation_failures = AtomicInt()
        self.n_anchor_recoveries = AtomicInt()   # wait-free: 2nd-level escapes
        self.n_wf_escalations = AtomicInt()      # wait-free: careful fallbacks

    # ------------------------------------------------------------------ API
    def insert(self, key, value=None, ctx=None) -> bool:
        with self.smr.scope(ctx) as c:
            return self._insert_from(key, value, c)[0]

    def _insert_from(self, key, value, ctx, hint=None
                     ) -> Tuple[bool, ListNode]:
        """Insert body under the caller's guard; traversal resumes from
        ``hint`` (see batched.py for the pinning argument).  Returns
        (inserted, prev) — prev seeds the next batched operation."""
        smr = self.smr
        new = None
        while True:
            prev, curr, found = self._find(key, srch=False, ctx=ctx,
                                           start=hint)
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
            # CAS failed — someone raced; re-find and retry with same node

    def delete(self, key, ctx=None) -> bool:
        with self.smr.scope(ctx) as c:
            return self._delete_from(key, c)[0]

    def _delete_from(self, key, ctx, hint=None
                     ) -> Tuple[bool, ListNode, Optional[ListNode]]:
        """Delete body under the caller's guard, resuming from ``hint``.
        Returns (deleted, prev, node): ``node`` is the node WE logically
        deleted (exactly-once ownership via the mark CAS), still
        dereferenceable while the caller's guard is open."""
        smr = self.smr
        while True:
            prev, curr, found = self._find(key, srch=False, ctx=ctx,
                                           start=hint)
            hint = prev
            if not found:
                return False, prev, None
            nxt, nmark = curr.next_ref().get()
            if nmark:
                continue  # concurrently deleted; re-find (helps unlink)
            # logical deletion (paper Fig 2 L25)
            if not curr.next_ref().compare_exchange(nxt, False, nxt, True):
                continue
            # one physical-unlink attempt (Fig 2 L26); else leave to others
            if prev.next_ref().compare_exchange(curr, False, nxt, False):
                smr.retire(curr, ctx)
            return True, prev, curr

    def search(self, key) -> bool:
        """Read-only optimistic search — zero CAS (the Harris-vs-HM win)."""
        with self.smr.guard() as ctx:
            _, _, found = self._find(key, srch=True, ctx=ctx)
            return found

    contains = search

    # ------------------------------------------------------- SCOT Do_Find
    def _find(self, key, srch: bool, ctx=None, start=None
              ) -> Tuple[ListNode, Optional[ListNode], bool]:
        if ctx is None:
            ctx = self.smr.ctx()
        restarts = 0
        max_restarts = self.policy.max_restarts
        while True:
            out = self._find_attempt(key, srch, ctx, start)
            if out is not _RESTART:
                return out
            start = None  # restarts go back to the head
            self.n_restarts.fetch_add(1)
            restarts += 1
            if self.wait_free and restarts >= max_restarts:
                # §4 escalation: the optimistic fast path has been knocked
                # over `max_restarts` times by concurrent unlinks — switch
                # to the careful walk, whose progress is monotone.
                self.n_wf_escalations.fetch_add(1)
                return self._find_careful(key, ctx)

    def _find_attempt(self, key, srch: bool, ctx, start=None):
        smr = self.smr
        cumulative = smr.cumulative_protection
        ring = [] if (self.recovery and cumulative) else None
        wait_free = self.wait_free
        # §4 anchor: the safe node one step behind `prev`, pinned in
        # HP_ANCHOR.  Gives one-shot schemes (HP/HE) a second recovery
        # level: a head restart then needs BOTH prev and anchor deleted.
        anchor: Optional[ListNode] = None
        # Whether `prev`'s pin provably lives in Hp2 RIGHT NOW.  False for
        # the head and for a resumed-from hint: a hint returned by an
        # anchor-recovered find is pinned in Hp4, not Hp2 (batched.py's
        # Hp2 invariant holds only for normally-finished finds), so
        # copying Hp2 up would record an unpinned node as the anchor.
        prev_pinned = False

        prev: ListNode = start if start is not None else self.head
        curr, smark = smr.protect(prev.next_ref(), HP_CURR, ctx)
        if smark and prev is not self.head:
            # the resumed-from hint has been logically deleted: the edge out
            # of it proves nothing about its successor (it may sit inside an
            # unlinked chain) — restart from the head
            return _RESTART
        prev_next = curr  # value last read from prev.next (chain start marker)

        while True:
            # ---------------- Phase 1: safe zone (paper Fig 4 L7-17) -------
            while True:
                if curr is None:
                    return self._finish(prev, prev_next, None, srch, key, ctx)
                nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
                if nmark:
                    break  # curr is logically deleted → dangerous zone
                if curr.key >= key:
                    return self._finish(prev, prev_next, curr, srch, key, ctx)
                if ring is not None:
                    ring.append(curr)
                    if len(ring) > self.recovery_depth:
                        ring.pop(0)
                if wait_free:
                    if prev is anchor:
                        pass      # pin already lives in Hp4 (anchor resume)
                    elif prev_pinned:
                        # prev's pin lives in Hp2; copy it up (ascending
                        # dup 2→4, §3.2 rule) before Hp2 is overwritten —
                        # never downward, a descending copy can lose the
                        # pin to a concurrently ascending scan
                        smr.dup(HP_PREV, HP_ANCHOR, ctx)
                        anchor = prev
                    else:
                        # head / resumed hint: no provable slot pin ⇒ not
                        # a legal anchor (one advance of lost coverage)
                        anchor = None
                smr.dup(HP_CURR, HP_PREV, ctx)   # Hp1[curr] → Hp2 (prev)
                prev = curr
                prev_pinned = True
                smr.dup(HP_NEXT, HP_CURR, ctx)   # Hp0[next] → Hp1 (curr)
                prev_next = nxt
                curr = nxt

            # -------------- Phase 2: dangerous zone (Fig 4 L18-25) ---------
            # curr = first unsafe node == prev_next (the word in prev.next)
            if self.scot:
                smr.dup(HP_CURR, HP_UNSAFE, ctx)  # Hp1[curr] → Hp3 (first unsafe)
            chain_start = curr
            while True:
                curr = nxt  # advance into the chain (unmarked ref part)
                if curr is None:
                    # chain runs to the end of the list (Fig 4 L21 goto 27)
                    return self._finish(prev, chain_start, None, srch, key, ctx)
                smr.dup(HP_NEXT, HP_CURR, ctx)    # Hp0 → Hp1
                if self.scot:
                    # THE validation (paper Thm 1 inductive step): *before*
                    # dereferencing the just-reserved chain node, check the
                    # last safe node still points at the first unsafe node
                    # (unmarked).  Chains unlink only from their head
                    # (Lemma 1), so an intact prev→chain_start edge proves
                    # `curr` is still linked — hence unretired at this
                    # instant — and its reservation (published by the
                    # previous protect) now pins it.
                    if prev.next_ref().get() != (chain_start, False):
                        self.n_validation_failures.fetch_add(1)
                        resumed = self._recover(prev, ring, ctx, anchor)
                        if resumed is _RESTART:
                            return _RESTART
                        # a resume that MOVED prev (ring/anchor fallback)
                        # invalidates the Hp2 pin claim; `prev is anchor`
                        # keeps the anchor-resume case covered via Hp4
                        prev_pinned = prev_pinned and resumed[0] is prev
                        prev, curr, nxt, nmark = resumed
                        prev_next = curr
                        if curr is None:
                            return self._finish(prev, prev_next, None, srch,
                                                key, ctx)
                        if not nmark:
                            break  # resumed in the safe zone
                        smr.dup(HP_CURR, HP_UNSAFE, ctx)
                        chain_start = curr
                        continue
                # deref of `curr` — made safe by the validation above (SCOT)
                # or unprotected (scot=False: the Figure-1 bug, surfaced to
                # tests as UseAfterFreeError where HW would SEGFAULT)
                nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
                if not nmark:
                    break  # end of chain: curr is not logically deleted
            # Exited dangerous zone at unmarked `curr` (or resumed).  Check
            # position; if key not reached, resume Phase 1 — prev advances
            # past the (skipped) chain, which is the optimistic-traversal win.
            if curr.key >= key:
                return self._finish(prev, prev_next, curr, srch, key, ctx)
            if ring is not None:
                ring.append(curr)
                if len(ring) > self.recovery_depth:
                    ring.pop(0)
            if wait_free:
                if prev is anchor:
                    pass
                elif prev_pinned:
                    smr.dup(HP_PREV, HP_ANCHOR, ctx)  # same rule as Phase 1
                    anchor = prev
                else:
                    anchor = None
            smr.dup(HP_CURR, HP_PREV, ctx)
            prev = curr
            prev_pinned = True
            smr.dup(HP_NEXT, HP_CURR, ctx)   # Hp1 must pin nxt BEFORE Phase 1
            # re-reads its next word (which overwrites Hp0) — omitting this
            # shift leaves the new curr unpinned and, one step later, lets
            # dup(HP_CURR→HP_PREV) publish a stale node as prev's "pin"
            prev_next = nxt
            curr = nxt
            # loop back into Phase 1

    # ---------------------------------------------------------- recovery
    def _recover(self, prev: ListNode, ring, ctx, anchor=None):
        """§3.2.1: escape the dangerous zone instead of a full restart.

        The wait-free policy (§4, DESIGN.md §10) adds a second level for
        one-shot schemes: ``anchor`` — the safe node one step behind
        ``prev``, pinned in its own hazard slot (Hp4) — is tried after
        ``prev`` and the cumulative ring, so a head restart requires two
        distinct successful unlink CASes landing on the reader's path."""
        if not self.recovery:
            return _RESTART
        smr = self.smr
        # one-shot recovery: last safe node still unmarked → continue from it.
        # protect() re-publishes; the returned mark tells us whether `prev`
        # got logically deleted meanwhile (marked edge ⇒ unsafe to resume).
        curr, pmark = smr.protect(prev.next_ref(), HP_CURR, ctx)
        if not pmark:
            self.n_recoveries.fetch_add(1)
            if curr is None:
                return (prev, None, None, False)
            nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
            return (prev, curr, nxt, nmark)
        # prev itself got deleted.  Cumulative schemes (IBR/HLN) may fall
        # back through still-protected predecessors (Figure 6); HP/HE restart
        # (extra hazard slots would cost barriers — paper §3.2.1), unless
        # the wait-free policy bought the anchor slot.
        if ring is not None:
            while ring:
                cand = ring.pop()
                # ring nodes stay protected under cumulative schemes ⇒ safe
                curr, cmark = smr.protect(cand.next_ref(), HP_CURR, ctx)
                if cmark:
                    continue  # this predecessor was deleted too; fall back
                self.n_ring_recoveries.fetch_add(1)
                if curr is None:
                    return (cand, None, None, False)
                nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
                return (cand, curr, nxt, nmark)
        if anchor is not None and anchor is not prev \
                and anchor is not self.head:
            # anchor is pinned in Hp4 ⇒ dereferenceable even under HP/HE;
            # an unmarked edge out of it proves it is still linked, so the
            # protected successor is reachable — same argument as the
            # one-shot `prev` resume above.
            curr, amark = smr.protect(anchor.next_ref(), HP_CURR, ctx)
            if not amark:
                self.n_anchor_recoveries.fetch_add(1)
                if curr is None:
                    return (anchor, None, None, False)
                nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
                return (anchor, curr, nxt, nmark)
        return _RESTART

    # ----------------------------------------------- §4 careful slow path
    def _find_careful(self, key, ctx):
        """Wait-free escalation (DESIGN.md §10): a Harris-Michael-style
        walk.  Every marked node it meets is a *chain head* and is unlinked
        by this traversal's own CAS (preserving Lemma 1: chains still only
        ever shrink from their head, so concurrent SCOT validations stay
        sound); a failed unlink CAS means another thread removed that exact
        node — each marked obstruction is gone either way, it cannot knock
        the walk back twice.  The walk is NOT wait-free against arbitrary
        active writers: Michael's edge check also fails on a concurrent
        *insert* between prev and curr, so every restart is charged to a
        successful writer CAS (lock-free, same as the structure itself) —
        the unconditional bound the policy guarantees is the stalled-writer
        one (see DESIGN.md §10).  Trade-off (documented, §4): past the
        restart budget even a read-only search may CAS — the
        fast-path/slow-path shape of wait-free constructions."""
        smr = self.smr
        while True:
            prev: ListNode = self.head
            curr, _ = smr.protect(prev.next_ref(), HP_CURR, ctx)
            restart = False
            while True:
                if curr is None:
                    return (prev, None, False)
                nxt, nmark = smr.protect(curr.next_ref(), HP_NEXT, ctx)
                # re-validate the incoming edge (Michael's check)
                if prev.next_ref().get() != (curr, False):
                    restart = True
                    break
                if nmark:
                    # curr is the head of a marked chain: unlink it (one
                    # node, from the head — Lemma 1 shape) and retire it;
                    # unlinker-retires matches the delete path's rule.
                    if not prev.next_ref().compare_exchange(curr, False,
                                                            nxt, False):
                        restart = True
                        break
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
            if restart:
                self.n_restarts.fetch_add(1)

    # ------------------------------------------------------------ finish
    def _finish(self, prev, prev_next, curr, srch: bool, key, ctx):
        """Paper Fig 4 L26-40: optional chain unlink + position return."""
        smr = self.smr
        if not srch and prev_next is not curr:
            # unlink the whole chain [prev_next .. curr) with ONE CAS
            if not prev.next_ref().compare_exchange(prev_next, False, curr, False):
                return _RESTART
            chain = []
            node = prev_next
            while node is not curr:
                nxt = node.next_ref().get_ref()  # we unlinked it: safe
                chain.append(node)
                node = nxt
            smr.retire_batch(chain, ctx)  # one era read/tick, ≤1 scan
        found = curr is not None and curr.key == key
        return (prev, curr, found)

    # --------------------------------------------------------- debug utils
    def snapshot(self):
        """Single-threaded: list of live keys (skips marked nodes)."""
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
            "recoveries": self.n_recoveries.load(),
            "ring_recoveries": self.n_ring_recoveries.load(),
            "validation_failures": self.n_validation_failures.load(),
            "anchor_recoveries": self.n_anchor_recoveries.load(),
            "wf_escalations": self.n_wf_escalations.load(),
        }
