"""Natarajan-Mittal lock-free external BST with **SCOT** traversals (§3.3).

First *correct* implementation for HP/HE/IBR/Hyaline-1S per the paper (prior
ports were buggy — leaked or touched freed memory during optimistic
traversals; see paper footnote 3).

Layout (paper §2.5): keys live in leaves; internal nodes route.  Child edges
carry (flag, tag) bits: *flag* marks a leaf edge for logical deletion, *tag*
freezes the kept-sibling edge during cleanup.  A chain of consecutively
tagged edges is removed with ONE CAS at the ancestor (Figure 3) — the
optimistic-traversal property that breaks naive HP usage and that SCOT fixes.

SCOT here (paper §3.3): five hazard slots — current, parent, successor,
ancestor, leaf.  After each reservation of the current node, *if the edge
into it is flagged or tagged*, validate that ``ancestor``'s child field still
points at ``successor`` untagged; otherwise restart from the root (the paper
found ring-buffer recovery unhelpful for trees — on divergence the tree has
usually changed too much).

Safety argument (paper Theorem 4): removed-chain edges are permanently
non-clean (monotone flag/tag bits) and cleanup CASes expect *clean* words, so
(a) a traversal observing a clean edge cannot be inside a removed chain, and
(b) two cleanups can never both succeed on overlapping chains (no double
retire — additionally policed by ``SmrScheme.retire``'s assertion).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..atomics import AtomicInt
from ..smr.base import SmrScheme
from .node import TreeNode
from .traversal import UNSET, TraversalPolicy, resolve_ctor_policy

# hazard slot indices — dup() requires ascending moves (paper §3.2)
S_CURR = 0
S_PARENT = 1
S_SUCC = 2
S_ANC = 3
S_LEAF = 4

# sentinel keys: all user keys must be < INF0
INF0 = float("inf")


class _SeekRecord(NamedTuple):
    ancestor: TreeNode
    successor: TreeNode
    parent: TreeNode
    leaf: TreeNode


_RESTART = object()


class NMTree:
    """Lock-free external BST (set interface)."""

    HP_SLOTS = 5
    POLICIES = ("optimistic", "scot", "waitfree")

    @classmethod
    def slots_needed(cls, policy: TraversalPolicy) -> int:
        # the tree's wait-free variant helps instead of anchoring (the paper
        # found predecessor recovery unhelpful for trees) — no extra slot
        return cls.HP_SLOTS

    def __init__(self, smr: SmrScheme, policy=None, *, scot=UNSET):
        self.smr = smr
        self.policy = p = resolve_ctor_policy(type(self), smr, policy,
                                              scot=scot)
        self.scot = p.validates
        self.wait_free = p.wait_free
        # R(inf2) / S(inf1) sentinel skeleton; sentinels are never retired.
        #        R(inf2)
        #       /      \
        #     S(inf1)  leaf(inf2)
        #    /    \
        # leaf(inf1) leaf(inf2)
        self.S = TreeNode(INF0, is_leaf=False,
                          left=TreeNode(INF0, is_leaf=True),
                          right=TreeNode(INF0, is_leaf=True))
        self.R = TreeNode(INF0, is_leaf=False,
                          left=self.S,
                          right=TreeNode(INF0, is_leaf=True))
        self.n_restarts = AtomicInt()
        self.n_validation_failures = AtomicInt()
        self.n_unlink_cas = AtomicInt()
        self.n_wf_escalations = AtomicInt()  # wait-free: helping fallbacks
        self.n_wf_helps = AtomicInt()        # wait-free: cleanups from seeks

    # ------------------------------------------------------------------ API
    def search(self, key) -> bool:
        """Read-only optimistic search — no CAS (SCOT makes this legal)."""
        with self.smr.guard() as ctx:
            sr = self._seek(key, ctx)
            return sr.leaf.key == key

    contains = search

    def get_node(self, key, ctx):
        """Public lookup-with-node: the caller must be inside a guard scope
        and pass its ctx; the returned leaf is protected until that scope
        exits (slot ``S_LEAF``)."""
        sr = self._seek(key, ctx)
        return sr.leaf if sr.leaf.key == key else None

    def min_key(self):
        """Smallest live key, or ``None`` when the tree is empty.

        A leftmost descent is just a seek for ``-inf`` (every routing
        comparison goes left), so it inherits the policy's full SCOT
        validation / wait-free escalation machinery.  This is what makes the
        tree usable as an *ordered eviction index* (LRU: stamps ascend, the
        minimum stamp is the least-recently-used entry)."""
        with self.smr.guard() as ctx:
            leaf_key = self._seek(float("-inf"), ctx).leaf.key
        return None if leaf_key == INF0 else leaf_key

    def insert(self, key, value=None) -> bool:
        with self.smr.guard() as ctx:
            return self._insert(key, value, ctx)

    def _insert(self, key, value, ctx) -> bool:
        smr = self.smr
        new_leaf = None
        while True:
            sr = self._seek(key, ctx)
            leaf, parent = sr.leaf, sr.parent
            if leaf.key == key:
                return False
            child_field = parent.child_ref(key < parent.key)
            cref, cflag, ctag = child_field.get()
            if cref is not leaf:
                continue  # stale; re-seek
            if cflag or ctag:
                self._cleanup(key, sr, ctx)  # help the pending delete
                continue
            if new_leaf is None:
                new_leaf = TreeNode(key, value, is_leaf=True)
                smr.alloc_stamp(new_leaf)
            # new internal routes between the two leaves
            if key < leaf.key:
                internal = TreeNode(leaf.key, is_leaf=False,
                                    left=new_leaf, right=leaf)
            else:
                internal = TreeNode(key, is_leaf=False,
                                    left=leaf, right=new_leaf)
            smr.alloc_stamp(internal)
            if child_field.compare_exchange(leaf, False, False,
                                            internal, False, False):
                return True
            # failed: if a delete flagged/tagged this edge, help it
            cref, cflag, ctag = child_field.get()
            if cref is leaf and (cflag or ctag):
                self._cleanup(key, sr, ctx)

    def delete(self, key) -> bool:
        with self.smr.guard() as ctx:
            return self._delete(key, ctx)

    def _delete(self, key, ctx) -> bool:
        injected = False
        target_leaf: Optional[TreeNode] = None
        while True:
            sr = self._seek(key, ctx)
            if not injected:
                leaf = sr.leaf
                if leaf.key != key:
                    return False
                parent = sr.parent
                child_field = parent.child_ref(key < parent.key)
                # flag the leaf edge (logical deletion)
                if child_field.compare_exchange(leaf, False, False,
                                                leaf, True, False):
                    injected = True
                    target_leaf = leaf
                    if self._cleanup(key, sr, ctx):
                        return True
                else:
                    cref, cflag, ctag = child_field.get()
                    if cref is leaf and (cflag or ctag):
                        self._cleanup(key, sr, ctx)  # help whoever
            else:
                # cleanup mode: our leaf is flagged; finish the removal.
                # NOTE: tree nodes are never recycled (DESIGN.md) so the
                # identity test below cannot be fooled by ABA.
                if sr.leaf is not target_leaf:
                    return True  # somebody physically removed it
                if self._cleanup(key, sr, ctx):
                    return True

    # ------------------------------------------------------------ batched
    # A BST has no resumable linear position (the paper found even ring
    # recovery unhelpful for trees — on divergence the tree has changed too
    # much), so the batch entry points amortize the guard/ctx lifecycle
    # only: one scope, k seeks from the root.
    def search_many(self, keys, ctx=None):
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            for i, key in enumerate(keys):
                out[i] = self._seek(key, c).leaf.key == key
        return out

    def insert_many(self, keys, values=None, ctx=None):
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
        out = [False] * len(keys)
        if not len(keys):
            return out
        order = sorted(range(len(keys)), key=keys.__getitem__)
        with self.smr.scope(ctx, len(keys)) as c:
            for i in order:
                out[i] = self._delete(keys[i], c)
        return out

    # ------------------------------------------------------------- seek
    def _seek(self, key, ctx=None) -> _SeekRecord:
        if ctx is None:
            ctx = self.smr.ctx()
        restarts = 0
        helping = False
        max_restarts = self.policy.max_restarts
        while True:
            out = self._seek_attempt(key, ctx, helping)
            if out is not _RESTART:
                return out
            self.n_restarts.fetch_add(1)
            restarts += 1
            if self.wait_free and not helping and restarts >= max_restarts:
                # §4 escalation for the tree (DESIGN.md §10): convert the
                # restart loop into *helping* — subsequent descents finish
                # any pending flagged delete they collide with (the tree's
                # own cleanup), removing the obstruction instead of
                # spinning on it.
                self.n_wf_escalations.fetch_add(1)
                helping = True

    def _seek_attempt(self, key, ctx, helping: bool = False):
        smr = self.smr
        ancestor: TreeNode = self.R
        successor: TreeNode = self.S
        parent: TreeNode = self.S
        curr, cflag, ctag = smr.protect_edge(self.S.left_ref(), S_CURR, ctx)
        while curr is not None and not curr.is_leaf:
            if not ctag:
                # edge into curr is untagged → curr is the new successor
                smr.dup(S_PARENT, S_ANC, ctx)
                ancestor = parent
                smr.dup(S_CURR, S_SUCC, ctx)
                successor = curr
            smr.dup(S_CURR, S_PARENT, ctx)
            parent = curr
            go_left = key < curr.key
            child, f, t = smr.protect_edge(curr.child_ref(go_left), S_CURR,
                                           ctx)
            if self.scot and (f or t):
                # SCOT validation (paper §3.3): the ancestor→successor edge
                # must be intact and untagged, else the path may be a removed
                # chain → restart before dereferencing `child`.
                aref, aflag, atag = ancestor.child_ref(
                    key < ancestor.key).get()
                if aref is not successor or atag:
                    self.n_validation_failures.fetch_add(1)
                    return _RESTART
            if helping and f and child is not None and child.is_leaf:
                # wait-free escalation: the edge into this leaf is flagged —
                # a pending delete that keeps mutating our path.  Our seek
                # record is exactly the helper record `_insert` would use
                # (same key routes to the same leaf), and ancestor /
                # successor / parent are pinned in their slots, so finish
                # the removal and re-descend.  Flag/tag bits are monotone:
                # each obstruction can be helped at most once.
                self.n_wf_helps.fetch_add(1)
                self._cleanup(key, _SeekRecord(ancestor, successor,
                                               parent, child), ctx)
                return _RESTART
            curr, cflag, ctag = child, f, t
        smr.dup(S_CURR, S_LEAF, ctx)
        return _SeekRecord(ancestor, successor, parent, curr)

    # ------------------------------------------------------------ cleanup
    def _cleanup(self, key, sr: _SeekRecord, ctx=None) -> bool:
        """Physically remove the flagged leaf (and the tagged chain above it)
        with one CAS at the ancestor.  Returns True iff our CAS did it."""
        ancestor, successor, parent, leaf = sr
        successor_field = ancestor.child_ref(key < ancestor.key)
        if key < parent.key:
            child_field, sibling_field = parent.left_ref(), parent.right_ref()
        else:
            child_field, sibling_field = parent.right_ref(), parent.left_ref()
        cref, cflag, ctag = child_field.get()
        if not cflag:
            # the flag is on the other side (helping someone else's delete):
            # keep the key side, remove the sibling side
            child_field, sibling_field = sibling_field, child_field
        # freeze the kept edge so nothing can slip underneath (fetch-and-or)
        sibling_field.fetch_or(tag=True)
        kref, kflag, _ = sibling_field.get()
        self.n_unlink_cas.fetch_add(1)
        ok = successor_field.compare_exchange(
            successor, False, False,   # expected: clean edge to successor
            kref, kflag, False,        # new: kept child (flag preserved)
        )
        if ok:
            self._retire_chain(key, successor, parent, kept=kref, ctx=ctx)
        return ok

    def _retire_chain(self, key, successor: TreeNode, parent: TreeNode,
                      kept: Optional[TreeNode], ctx=None) -> None:
        """Retire the unlinked chain: internal nodes successor..parent along
        the routing path plus their off-path flagged leaves (all edges in the
        removed set are permanently flagged/tagged — reads are on nodes only
        we can retire, cf. class docstring)."""
        smr = self.smr
        chain = []
        node = successor
        while node is not None and node is not kept:
            if node.is_leaf:
                chain.append(node)
                break
            l_ref = node.left_ref_unsafe().get_ref()
            r_ref = node.right_ref_unsafe().get_ref()
            go_left = key < node._key
            nxt = l_ref if go_left else r_ref
            off = r_ref if go_left else l_ref
            chain.append(node)
            if node is parent:
                # off-path side here is the *kept* subtree — not ours.
                # continue into the flagged leaf (routing side), unless the
                # kept side was the routing side (helping case).
                node = nxt if nxt is not kept else off
            else:
                # middle chain node: off-path child is a flagged leaf that
                # the winning unlinker (us) retires
                if off is not None and off is not kept:
                    chain.append(off)
                node = nxt
        # (node is kept) → done; kept subtree was relinked by the CAS.
        # The whole removed chain was unlinked by ONE ancestor CAS — retire
        # it as one event (single era read/tick, at most one scan).
        smr.retire_batch(chain, ctx)

    # --------------------------------------------------------- debug utils
    def snapshot(self):
        """Single-threaded: sorted list of live keys."""
        out = []

        def rec(node):
            if node is None:
                return
            if node.is_leaf:
                if node._key != INF0:
                    out.append(node._key)
                return
            rec(node.left_ref_unsafe().get_ref())
            rec(node.right_ref_unsafe().get_ref())

        rec(self.R)
        return out

    def stats(self):
        return {
            "restarts": self.n_restarts.load(),
            "validation_failures": self.n_validation_failures.load(),
            "unlink_cas": self.n_unlink_cas.load(),
            "wf_escalations": self.n_wf_escalations.load(),
            "wf_helps": self.n_wf_helps.load(),
        }
