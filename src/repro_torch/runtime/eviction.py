"""Named eviction policies for the prefix cache — a registry mirroring
:mod:`repro.core.structures.traversal`.

The pre-session engine hardcoded its pressure response (``evict_oldest(4)``);
here both the *victim order* and the *pressure quota* are policy objects
resolved by name, so ``ServingConfig(eviction="lru")`` swaps the whole
behavior without touching the engine:

* ``fifo`` — insertion order (the old ring, now named).  Quota on a pool
  pressure event is the old magic number, 4, as a documented class attr.
* ``pressure`` — FIFO order but the quota scales with cache occupancy, so a
  large cache sheds load faster than four entries per starved admission.
* ``lru`` — least-recently-used order via an **NM-tree ordered index**:
  every insert/hit stamps the entry with a monotone counter; the tree keyed
  by stamp makes "oldest stamp" an ordered-index min query
  (:meth:`NMTree.min_key`), exactly the ranged-eviction use the prefix-cache
  docstring promised for the tree variant.
* ``swap`` — ``pressure`` ordering and quota, plus the ``swaps`` marker the
  serving engine reads: when shedding cache entries still cannot cover an
  admission, the engine may *preempt* lower-priority active sequences,
  spilling their K/V pages to the host-side :class:`~repro.runtime.swap
  .SwapArena` (``ServingConfig.swap_bytes``) and resuming them later
  bit-identically (DESIGN.md §15).

Policies are *stateful per cache* — ``as_eviction_policy`` constructs a
fresh instance per name so two shards never share a ring or an index.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

__all__ = [
    "EvictionPolicy",
    "FifoEviction",
    "PressureEviction",
    "LruEviction",
    "SwapEviction",
    "EVICTION_POLICIES",
    "eviction_policies",
    "as_eviction_policy",
]


class EvictionPolicy:
    """Victim ordering + pressure sizing for one :class:`PrefixCache`."""

    name = "base"
    PRESSURE_BATCH = 4  # entries evicted per pool-pressure event

    def bind(self, cache) -> None:
        """Called once by the owning cache before any traffic."""
        self.cache = cache

    # -- bookkeeping hooks (called OUTSIDE the cache's SMR guard scopes; an
    # -- implementation may open its own guard, e.g. the LRU tree index) ----
    def record_insert(self, bucket_idx: int, key: int) -> None:
        raise NotImplementedError

    def record_use(self, key: int) -> None:
        """A lookup validated a hit on ``key`` (recency signal)."""

    def peek(self, key: int):
        """Opaque recency token for ``key`` (captured by the cache BEFORE
        it pops an entry, handed back to :meth:`forget` after)."""
        return None

    def forget(self, key: int, token=None) -> None:
        """``key`` was evicted through a path that bypassed
        :meth:`next_victim` (direct ``cache.evict(key)``).  ``token`` is
        the :meth:`peek` capture from before the pop: an implementation
        must only drop index state belonging to that incarnation — a
        racing re-insert/re-use of the same key has a newer token and must
        keep its index entry."""

    # -- selection ---------------------------------------------------------
    def next_victim(self) -> Optional[int]:
        """Next candidate key, or ``None`` when the index is drained.  May
        return a stale key (entry already gone) — the cache skips those
        without burning its budget."""
        raise NotImplementedError

    def pressure_quota(self, cache, pool) -> int:
        """How many entries to evict on one pool-pressure event."""
        return self.PRESSURE_BATCH


class FifoEviction(EvictionPolicy):
    """Insertion-order ring (the engine's original behavior, named)."""

    name = "fifo"

    def bind(self, cache) -> None:
        super().bind(cache)
        self._lock = threading.Lock()
        # deque so the hot evict path pops O(1); stale slots (entries a
        # racing evictor already removed) are skipped by the cache
        self._ring: Deque[Tuple[int, int]] = deque()

    def record_insert(self, bucket_idx: int, key: int) -> None:
        with self._lock:
            self._ring.append((bucket_idx, key))

    def next_victim(self) -> Optional[int]:
        with self._lock:
            if not self._ring:
                return None
            return self._ring.popleft()[1]


class PressureEviction(FifoEviction):
    """FIFO order, occupancy-scaled quota: a pressure event evicts
    ``max(4, entries // 8)`` entries, so a nearly-full cache frees pages in
    proportion to what it holds instead of four-at-a-time."""

    name = "pressure"

    def pressure_quota(self, cache, pool) -> int:
        return max(self.PRESSURE_BATCH, cache.n_entries.load() // 8)


class LruEviction(EvictionPolicy):
    """Least-recently-used via the NM-tree ordered index.

    ``_touch`` assigns a fresh monotone stamp under a lock (dict maps stay
    exact), then updates the tree *outside* the lock — tree insert/delete
    may interleave between two touches of the same key, so the tree can
    transiently hold a stale stamp; :meth:`next_victim` detects staleness by
    checking the stamp is still the key's current one and skips it.  The
    tree shares the cache's SMR scheme (its retired internal nodes flow
    through the same reclamation the paper studies)."""

    name = "lru"

    def bind(self, cache) -> None:
        super().bind(cache)
        from .. import api  # runtime already depends on the facade
        self.index = api.build("NMTree", smr=cache.smr)
        self._lock = threading.Lock()
        self._clock = 0
        self._stamp_of: Dict[int, int] = {}   # key   -> current stamp
        self._key_of: Dict[int, int] = {}     # stamp -> key

    def _touch(self, key: int) -> None:
        with self._lock:
            self._clock += 1
            stamp = self._clock
            old = self._stamp_of.get(key)
            self._stamp_of[key] = stamp
            self._key_of[stamp] = key
            if old is not None:
                del self._key_of[old]
        if old is not None:
            self.index.delete(old)
        self.index.insert(stamp, key)

    def record_insert(self, bucket_idx: int, key: int) -> None:
        self._touch(key)

    def record_use(self, key: int) -> None:
        self._touch(key)

    def peek(self, key: int):
        with self._lock:
            return self._stamp_of.get(key)

    def forget(self, key: int, token=None) -> None:
        with self._lock:
            stamp = self._stamp_of.get(key)
            if stamp is None or (token is not None and stamp != token):
                # the key was re-inserted (or re-used) since the caller's
                # peek — the newer incarnation owns the index entry now
                return
            del self._stamp_of[key]
            self._key_of.pop(stamp, None)
        self.index.delete(stamp)

    def next_victim(self) -> Optional[int]:
        while True:
            stamp = self.index.min_key()
            if stamp is None:
                return None
            if not self.index.delete(stamp):
                continue  # lost the race to a concurrent evictor
            with self._lock:
                key = self._key_of.pop(stamp, None)
                if key is not None and self._stamp_of.get(key) == stamp:
                    del self._stamp_of[key]
                elif key is not None:
                    # key was re-touched between our min and our delete —
                    # its newer stamp is still in the tree; not a victim
                    key = None
            if key is not None:
                return key


class SwapEviction(PressureEviction):
    """``pressure`` escalated to preemption: identical cache-entry ordering
    and quota, plus the ``swaps`` class marker.  The serving engine checks
    the marker on its cache's bound policy — when a pressure event STILL
    cannot cover an admission, it preempts lower-priority active sequences
    into the host swap arena instead of bouncing the request forever
    (engine ``_admit``; ordering argument in DESIGN.md §15).  Kept as an
    eviction policy (not an engine flag) so the overload response is
    selected exactly where the rest of the pressure response is."""

    name = "swap"
    swaps = True


EVICTION_POLICIES = {
    cls.name: cls for cls in (FifoEviction, PressureEviction, LruEviction,
                              SwapEviction)
}


def eviction_policies() -> List[str]:
    return list(EVICTION_POLICIES)


def as_eviction_policy(policy: Union[str, EvictionPolicy, None]
                       ) -> EvictionPolicy:
    """Name → fresh policy instance (stateful: one per cache); instances
    pass through; ``None`` picks ``fifo`` (the legacy behavior)."""
    if policy is None:
        return FifoEviction()
    if isinstance(policy, EvictionPolicy):
        return policy
    try:
        return EVICTION_POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {policy!r}; choose from "
                         f"{eviction_policies()}") from None
