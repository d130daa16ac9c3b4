"""The serving engine's ``lru`` eviction policy: the copied
:class:`~repro_torch.runtime.eviction.LruEviction` with a shallow index.

The copied policy enters every fresh recency stamp into its NM-tree at
once.  A fresh stamp is always the largest key, and an external BST fed
ascending keys keeps them all on its rightmost path, so each touch walks
every live stamp (under the scheme's per-edge protection), and a finished
request's insert, one touch a page boundary, costs the square of the cache.

Here a touch assigns its stamp exactly as the copy does (same clock, same
maps, same lock) and queues it; :meth:`next_victim`, the only reader of the
tree's minimum, first enters the queue as one batch: the largest stamp
first, then the rest median-first.  Every queued stamp lies above every
stamp in the tree, so the batch's largest lengthens the rightmost path by
one node and the rest hang balanced to its left: a seek walks about the
live batches plus log2 of a batch.  Median-first alone would lengthen the
rightmost path by log2 of each batch.

Stamps, ``peek`` tokens and the victim order are those of the copy; the
copy's stale-stamp skip in ``next_victim`` also covers a stamp that a
client's re-touch could not delete because the flush entering it had not
reached the tree yet.  Client threads only queue and delete; the threads
that pick victims (the engine's, and the watchdog's pressure sweep) flush
and read the minimum one at a time.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..runtime.eviction import LruEviction


def median_first(stamps: List[int]) -> List[int]:
    """``stamps`` (ascending) in flush order: the largest, then the middle
    of the rest, then the middles of each half, breadth first."""
    order = [stamps[-1]]
    spans = [(0, len(stamps) - 1)]  # half-open ranges of the rest
    for lo, hi in spans:  # the loop appends to the list it walks
        if lo < hi:
            mid = (lo + hi) // 2
            order.append(stamps[mid])
            spans.append((lo, mid))
            spans.append((mid + 1, hi))
    return order


class BatchedLruEviction(LruEviction):
    """``lru`` whose NM-tree takes each batch of stamps largest-first,
    then median-first (module docstring)."""

    def bind(self, cache) -> None:
        super().bind(cache)
        # stamp -> key, stamped but not yet in the tree; ascending, since
        # stamps are appended under the lock in clock order
        self._queued: Dict[int, int] = {}
        # the engine thread and the watchdog's pressure sweep both pick
        # victims: one flush enters its whole batch before any minimum is
        # read, or a half-entered batch would offer its largest stamp
        self._victim_lock = threading.Lock()
        self.n_flushes = 0         # flushes that entered a batch
        self.n_flushed_stamps = 0  # stamps they entered

    def _touch(self, key: int) -> None:
        with self._lock:
            self._clock += 1
            stamp = self._clock
            old = self._stamp_of.get(key)
            self._stamp_of[key] = stamp
            self._key_of[stamp] = key
            in_tree = False
            if old is not None:
                del self._key_of[old]
                # a queued old stamp never reached the tree
                in_tree = self._queued.pop(old, None) is None
            self._queued[stamp] = key
        if in_tree:
            self.index.delete(old)

    def forget(self, key: int, token=None) -> None:
        with self._lock:
            stamp = self._stamp_of.get(key)
            if stamp is None or (token is not None and stamp != token):
                return  # a newer incarnation owns the index entry
            del self._stamp_of[key]
            self._key_of.pop(stamp, None)
            if self._queued.pop(stamp, None) is not None:
                return
        self.index.delete(stamp)

    def _flush(self) -> None:
        with self._lock:
            if not self._queued:
                return
            batch, self._queued = self._queued, {}
        for stamp in median_first(list(batch)):
            self.index.insert(stamp, batch[stamp])
        self.n_flushes += 1
        self.n_flushed_stamps += len(batch)

    def next_victim(self) -> Optional[int]:
        with self._victim_lock:
            self._flush()
            return super().next_victim()
