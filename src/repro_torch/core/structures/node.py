"""Node types shared by the non-blocking structures."""

from __future__ import annotations

from typing import Optional

from ..atomics import AtomicFlaggedRef, AtomicMarkableRef, SmrNode

NEG_INF = float("-inf")
POS_INF = float("inf")


class ListNode(SmrNode):
    """Harris / Harris-Michael list node.

    The mark bit on ``next`` (read via :meth:`next_ref`) is *this node's*
    logical-deletion bit (paper §2.3).  All field accesses go through
    poisoning checks so a traversal that touches reclaimed memory fails
    deterministically (the shim's analogue of Figure 1's SEGFAULT).
    """

    __slots__ = ("_key", "_value", "_next")

    def __init__(self, key, value=None):
        super().__init__()
        self._key = key
        self._value = value
        self._next: AtomicMarkableRef = AtomicMarkableRef()

    def reinit(self, key, value=None):
        """Recycler hook: same identity (and same *next* cell → real ABA)."""
        self._key = key
        self._value = value
        self._next.set(None, False)

    @property
    def key(self):
        self.check_alive()
        return self._key

    @property
    def value(self):
        self.check_alive()
        return self._value

    def next_ref(self) -> AtomicMarkableRef:
        self.check_alive()
        return self._next

    # teardown/debug only: no poisoning check
    def next_ref_unsafe(self) -> AtomicMarkableRef:
        return self._next


class TowerNode(SmrNode):
    """Skip-list node: a tower of markable next pointers (Fraser §2.3)."""

    __slots__ = ("_key", "_value", "_next", "height", "link_pending")

    def __init__(self, key, height: int, value=None):
        super().__init__()
        self._key = key
        self._value = value
        self.height = height
        self._next = tuple(AtomicMarkableRef() for _ in range(height))
        # number of inserts currently extending this tower's upper levels;
        # the deletion owner retires only once this drops to zero
        from ..atomics import AtomicInt
        self.link_pending = AtomicInt(0)

    def reinit(self, key, height: int, value=None):
        raise NotImplementedError("skip-list nodes are not recycled")

    @property
    def key(self):
        self.check_alive()
        return self._key

    @property
    def value(self):
        self.check_alive()
        return self._value

    def next_ref(self, level: int) -> AtomicMarkableRef:
        self.check_alive()
        return self._next[level]

    def next_ref_unsafe(self, level: int) -> AtomicMarkableRef:
        return self._next[level]


class TreeNode(SmrNode):
    """Natarajan-Mittal tree node.  Internal nodes route; leaves hold keys.

    Child edges are :class:`AtomicFlaggedRef` words carrying (flag, tag) bits
    (paper §2.5): *flag* marks the leaf edge for logical deletion, *tag*
    freezes an edge during cleanup.
    """

    __slots__ = ("_key", "_value", "_left", "_right", "is_leaf")

    def __init__(self, key, value=None, is_leaf: bool = True,
                 left: Optional["TreeNode"] = None,
                 right: Optional["TreeNode"] = None):
        super().__init__()
        self._key = key
        self._value = value
        self.is_leaf = is_leaf
        self._left: AtomicFlaggedRef = AtomicFlaggedRef(left)
        self._right: AtomicFlaggedRef = AtomicFlaggedRef(right)

    def reinit(self, key, value=None, is_leaf=True, left=None, right=None):
        self._key = key
        self._value = value
        self.is_leaf = is_leaf
        self._left.set(left, False, False)
        self._right.set(right, False, False)

    @property
    def key(self):
        self.check_alive()
        return self._key

    @property
    def value(self):
        self.check_alive()
        return self._value

    def left_ref(self) -> AtomicFlaggedRef:
        self.check_alive()
        return self._left

    def right_ref(self) -> AtomicFlaggedRef:
        self.check_alive()
        return self._right

    def child_ref(self, go_left: bool) -> AtomicFlaggedRef:
        self.check_alive()
        return self._left if go_left else self._right

    def left_ref_unsafe(self) -> AtomicFlaggedRef:
        return self._left

    def right_ref_unsafe(self) -> AtomicFlaggedRef:
        return self._right
