"""Linearizable atomic primitives + reclamation poisoning.

The paper (SCOT) assumes sequential consistency and hardware CAS.  CPython
gives us linearizability for free on single bytecode ops; we exploit that on
the **read path** by packing each atomic word into one immutable tuple stored
in a single slot: ``get()``/``load()`` is a lone attribute load — no lock —
and always observes a consistent (ref, mark[, tag]) snapshot because the
tuple is replaced wholesale, never mutated (DESIGN.md §2 has the full memory
-model argument).  Only read-modify-write ops (``compare_exchange``, ``set``,
``swap``, ``fetch_*``) need mutual exclusion; they draw their lock from a
module-level striped pool keyed by object address, so cells cost no per-node
``threading.Lock`` allocation.  The *algorithms* built on top are verbatim
the paper's; only the memory substrate differs.

Reclamation is modeled by **poisoning**: ``free(node)`` tombstones the node and
any later field access raises :class:`UseAfterFreeError`.  This converts the
paper's Figure-1 SEGFAULT into a deterministic, testable assertion.

A :class:`Recycler` free-list makes the ABA problem *actually exercisable*:
freed nodes are resurrected with identical object identity, so a pointer-equal
CAS can succeed on a recycled node exactly as on real hardware.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")

__all__ = [
    "UseAfterFreeError",
    "AtomicInt",
    "AtomicRef",
    "AtomicMarkableRef",
    "AtomicFlaggedRef",
    "SmrNode",
    "Recycler",
]


# Striped lock pool: cells share locks, so a million list nodes cost zero
# extra Lock objects.  Safe because no code path ever holds two cell locks
# at once (every RMW takes exactly one).  64 stripes keeps the collision
# probability under contention negligible at benchmark thread counts.
_N_STRIPES = 64
_LOCK_POOL = tuple(threading.Lock() for _ in range(_N_STRIPES))


def _striped_lock(obj: object) -> threading.Lock:
    # >>4: CPython aligns allocations, low address bits carry no entropy
    return _LOCK_POOL[(id(obj) >> 4) & (_N_STRIPES - 1)]


class UseAfterFreeError(RuntimeError):
    """Raised when a poisoned (reclaimed) node is dereferenced.

    The CPU-paper equivalent is a SEGFAULT / silent corruption; here it is a
    deterministic failure so tests can *prove* unsafety of non-SCOT traversals.
    """


class AtomicInt:
    """Linearizable integer cell (used for epoch/era clocks)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0):
        self._lock = _striped_lock(self)
        self._value = value

    def load(self) -> int:
        return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value

    def fetch_add(self, delta: int = 1) -> int:
        with self._lock:
            old = self._value
            self._value = old + delta
            return old

    def add_fetch(self, delta: int = 1) -> int:
        with self._lock:
            self._value += delta
            return self._value

    def compare_exchange(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._value == expected:
                self._value = desired
                return True
            return False

    def max_update(self, value: int) -> int:
        """Atomically self = max(self, value); returns new value."""
        with self._lock:
            if value > self._value:
                self._value = value
            return self._value


class AtomicRef(Generic[T]):
    """Single-word atomic reference with CAS."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: Optional[T] = None):
        self._lock = _striped_lock(self)
        self._value = value

    def load(self) -> Optional[T]:
        return self._value

    def store(self, value: Optional[T]) -> None:
        with self._lock:
            self._value = value

    def compare_exchange(self, expected: Optional[T], desired: Optional[T]) -> bool:
        with self._lock:
            if self._value is expected:
                self._value = desired
                return True
            return False

    def swap(self, value: Optional[T]) -> Optional[T]:
        with self._lock:
            old = self._value
            self._value = value
            return old


class AtomicMarkableRef(Generic[T]):
    """(pointer, mark-bit) packed word — Harris-style stolen bit.

    ``mark=True`` on a node's *next* field means the node that owns the field
    is logically deleted.  The word is one immutable ``(ref, mark)`` tuple:
    readers take a single snapshot (no torn ref/mark pairing is observable),
    and CAS compares the full word (pointer identity AND mark), exactly like
    comparing the raw tagged word on hardware.
    """

    __slots__ = ("_lock", "_word")

    def __init__(self, ref: Optional[T] = None, mark: bool = False):
        self._lock = _striped_lock(self)
        self._word: Tuple[Optional[T], bool] = (ref, mark)

    def get(self) -> Tuple[Optional[T], bool]:
        return self._word

    def get_ref(self) -> Optional[T]:
        return self._word[0]

    def get_mark(self) -> bool:
        return self._word[1]

    def set(self, ref: Optional[T], mark: bool = False) -> None:
        with self._lock:
            self._word = (ref, mark)

    def compare_exchange(
        self,
        expected_ref: Optional[T],
        expected_mark: bool,
        new_ref: Optional[T],
        new_mark: bool,
    ) -> bool:
        with self._lock:
            ref, mark = self._word
            if ref is expected_ref and mark == expected_mark:
                self._word = (new_ref, new_mark)
                return True
            return False


class AtomicFlaggedRef(Generic[T]):
    """(pointer, flag-bit, tag-bit) word for the Natarajan-Mittal tree edges.

    ``flag`` marks the edge to a leaf under deletion; ``tag`` freezes an edge
    during cleanup so no insertion can slip underneath (paper §2.5).  Packed
    as one immutable ``(ref, flag, tag)`` tuple like
    :class:`AtomicMarkableRef`.
    """

    __slots__ = ("_lock", "_word")

    def __init__(self, ref: Optional[T] = None, flag: bool = False, tag: bool = False):
        self._lock = _striped_lock(self)
        self._word: Tuple[Optional[T], bool, bool] = (ref, flag, tag)

    def get(self) -> Tuple[Optional[T], bool, bool]:
        return self._word

    def get_ref(self) -> Optional[T]:
        return self._word[0]

    def set(self, ref: Optional[T], flag: bool = False, tag: bool = False) -> None:
        with self._lock:
            self._word = (ref, flag, tag)

    def compare_exchange(
        self,
        exp_ref: Optional[T],
        exp_flag: bool,
        exp_tag: bool,
        new_ref: Optional[T],
        new_flag: bool,
        new_tag: bool,
    ) -> bool:
        with self._lock:
            ref, flag, tag = self._word
            if ref is exp_ref and flag == exp_flag and tag == exp_tag:
                self._word = (new_ref, new_flag, new_tag)
                return True
            return False

    def fetch_or(self, flag: bool = False, tag: bool = False) -> Tuple[Optional[T], bool, bool]:
        """Atomic OR of the mark bits (NM tree tags sibling edges this way)."""
        with self._lock:
            old = self._word
            self._word = (old[0], old[1] or flag, old[2] or tag)
            return old


_node_ids = itertools.count()


class SmrNode:
    """Base class for reclaimable nodes.

    Fields (birth/retire eras, batch links) form the "SMR header" the paper's
    API requires (§2.2).  Subclasses must list their payload fields in
    ``__slots__`` and read them via properties that call :meth:`check_alive`
    (the data structures in ``repro.core.structures`` do this).
    """

    __slots__ = (
        "node_id",
        "birth_era",
        "retire_era",
        "_freed",
        "_retired",
        "_batch_next",
        "_incarnation",
    )

    def __init__(self):
        self.node_id = next(_node_ids)
        self.birth_era = 0
        self.retire_era = 0
        self._freed = False
        self._retired = False
        self._batch_next: Optional["SmrNode"] = None
        self._incarnation = 0

    # -- poisoning ---------------------------------------------------------
    def check_alive(self) -> None:
        if self._freed:
            raise UseAfterFreeError(
                f"access to reclaimed node id={self.node_id} "
                f"(incarnation={self._incarnation})"
            )

    def poison(self) -> None:
        self._freed = True

    def resurrect(self) -> None:
        """Recycler support: same identity, new lifetime (ABA-capable)."""
        self._freed = False
        self._retired = False
        self._incarnation += 1
        self._batch_next = None

    @property
    def is_freed(self) -> bool:
        return self._freed


class Recycler:
    """Optional free-list allocator so reclaimed nodes are *reused* with the
    same object identity — this is what makes ABA physically possible in the
    shim and is what HP index Hp3 in SCOT exists to prevent (paper §3.2)."""

    def __init__(self, factory):
        self._factory = factory
        self._free: list = []
        self._lock = threading.Lock()

    def alloc(self, *args: Any, **kwargs: Any):
        with self._lock:
            node = self._free.pop() if self._free else None
        if node is None:
            return self._factory(*args, **kwargs)
        node.resurrect()
        node.reinit(*args, **kwargs)
        return node

    def free(self, node: SmrNode) -> None:
        node.poison()
        with self._lock:
            self._free.append(node)
