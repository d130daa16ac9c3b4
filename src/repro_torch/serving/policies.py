"""Named admission + scheduler policies for the serving session — plus the
eviction registry re-exported from :mod:`repro.runtime.eviction`, so
``repro.serving.policies`` is the one place serving-policy names resolve
(mirroring how :mod:`repro.api` resolves traversal-policy names).

An admission policy owns the *waiting queue representation* of one shard:
the engine only ever calls ``push`` / ``pop`` / ``requeue`` / ``drain``
under its own lock, so a policy is pure ordering logic.

* ``fifo`` — arrival order (the old ``list.pop(0)``, now a deque).
* ``priority`` — max-heap on ``Request.priority`` (ties arrival-ordered);
  a pool-pressure ``requeue`` goes back ahead of equal-priority peers, so
  pressure cannot starve a request behind its own cohort.

A scheduler policy divides one engine step's *prefill token budget*
(``ServingConfig.prefill_chunk_tokens``) among the sequences still in the
``prefilling`` state.  The batched decode for in-flight sequences runs every
step regardless — scheduler policies only shape how prompt ingestion is
chunked, never whether decoders advance (DESIGN.md §12):

* ``chunked`` — head-of-line: the budget goes to the oldest prefilling
  sequence first; budget left over after a prompt finishes spills to the
  next, so short prompts behind a long one still start the same step.
* ``oneshot`` — the pre-chunking behavior: every prefilling prompt is
  ingested whole in one step (the budget is ignored).  One long prompt
  stalls every active decoder for its full prefill — kept as the named
  baseline the interference tests and benches compare against.
* ``roundrobin`` — the budget is split evenly (page-multiple floor, at
  least one page each while budget lasts) across all prefilling sequences,
  trading head-of-line TTFT for equal prompt progress.
* ``packed`` — chunked's head-of-line-with-spill grants, PLUS the
  ``packs`` marker: the engine packs the whole plan into ONE fixed-shape
  ``(1, C)`` chunk call with per-lane segment ids (MaxText MLPerf
  offline-serving style) instead of one kernel call per sequence, so a
  wave of short prompts shares a chunk instead of each wasting most of one
  (DESIGN.md §13).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import List, Optional, Sequence, Tuple, Union

from ..runtime.eviction import (  # noqa: F401  (re-exported surface)
    EVICTION_POLICIES,
    EvictionPolicy,
    FifoEviction,
    LruEviction,
    PressureEviction,
    as_eviction_policy,
    eviction_policies,
)

__all__ = [
    "AdmissionPolicy",
    "FifoAdmission",
    "PriorityAdmission",
    "ADMISSION_POLICIES",
    "admission_policies",
    "as_admission_policy",
    "SchedulerPolicy",
    "ChunkedPrefill",
    "OneShotPrefill",
    "RoundRobinPrefill",
    "PackedPrefill",
    "SCHEDULER_POLICIES",
    "scheduler_policies",
    "as_scheduler_policy",
    # re-exported eviction surface
    "EvictionPolicy",
    "FifoEviction",
    "PressureEviction",
    "LruEviction",
    "EVICTION_POLICIES",
    "eviction_policies",
    "as_eviction_policy",
]


class AdmissionPolicy:
    """Queue discipline for one shard's waiting requests.  All methods are
    called with the shard's queue lock held — implementations need no
    locking of their own."""

    name = "base"

    def new_queue(self):
        raise NotImplementedError

    def push(self, queue, req) -> None:
        raise NotImplementedError

    def pop(self, queue) -> Optional[object]:
        raise NotImplementedError

    def peek(self, queue) -> Optional[object]:
        """The request :meth:`pop` would return, WITHOUT removing it —
        the engine's preemption check (does the queue head outrank the
        lowest-priority active sequence?) must not dequeue anything."""
        raise NotImplementedError

    def requeue(self, queue, req) -> None:
        """Pool-pressure path: the request could not be admitted and must
        come back *before* its peers."""
        raise NotImplementedError

    def drain(self, queue) -> List[object]:
        """Remove and return every queued request (shutdown)."""
        raise NotImplementedError

    def purge(self, queue, pred) -> List[object]:
        """Remove and return every queued request matching ``pred``,
        preserving the order of the rest (the engine's deadline sweep:
        expired/cancelled requests must fail out NOW, not whenever a
        full decode batch finally lets admission pop them)."""
        raise NotImplementedError


class FifoAdmission(AdmissionPolicy):
    name = "fifo"

    def new_queue(self):
        return deque()

    def push(self, queue, req) -> None:
        queue.append(req)

    def pop(self, queue):
        return queue.popleft() if queue else None

    def peek(self, queue):
        return queue[0] if queue else None

    def requeue(self, queue, req) -> None:
        queue.appendleft(req)

    def drain(self, queue):
        out = list(queue)
        queue.clear()
        return out

    def purge(self, queue, pred):
        out = [req for req in queue if pred(req)]
        if out:
            kept = [req for req in queue if not pred(req)]
            queue.clear()
            queue.extend(kept)
        return out


class PriorityAdmission(AdmissionPolicy):
    """Heap of ``(-priority, seq, req)``: higher ``Request.priority`` pops
    first, equal priorities in arrival order.  ``requeue`` uses a counter
    that only decreases, so a pressure-bounced request sorts ahead of every
    same-priority arrival."""

    name = "priority"

    def __init__(self):
        self._arrivals = itertools.count()
        self._bounces = itertools.count(start=-1, step=-1)

    def new_queue(self):
        return []

    def push(self, queue, req) -> None:
        heapq.heappush(queue, (-getattr(req, "priority", 0),
                               next(self._arrivals), req))

    def pop(self, queue):
        return heapq.heappop(queue)[2] if queue else None

    def peek(self, queue):
        return queue[0][2] if queue else None

    def requeue(self, queue, req) -> None:
        heapq.heappush(queue, (-getattr(req, "priority", 0),
                               next(self._bounces), req))

    def drain(self, queue):
        out = [heapq.heappop(queue)[2] for _ in range(len(queue))]
        return out

    def purge(self, queue, pred):
        out = [req for _, _, req in queue if pred(req)]
        if out:
            kept = [item for item in queue if not pred(item[2])]
            queue[:] = kept
            heapq.heapify(queue)
        return out


ADMISSION_POLICIES = {
    cls.name: cls for cls in (FifoAdmission, PriorityAdmission)
}


def admission_policies() -> List[str]:
    return list(ADMISSION_POLICIES)


def as_admission_policy(policy: Union[str, AdmissionPolicy, None]
                        ) -> AdmissionPolicy:
    """Name → fresh policy instance (stateful: one per shard); instances
    pass through; ``None`` picks ``fifo``."""
    if policy is None:
        return FifoAdmission()
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return ADMISSION_POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown admission policy {policy!r}; choose "
                         f"from {admission_policies()}") from None


# --------------------------------------------------------------- scheduler
class SchedulerPolicy:
    """Fairness discipline for chunked prefill: divide one step's prefill
    token budget among the prefilling sequences.

    ``plan`` receives the shard's prefilling sequences in admission order
    (each exposes ``seq.filled`` — prompt tokens whose K/V already sit in
    pages — and ``seq.req.prompt``), the step's token budget, and the page
    size; it returns ``[(seq, grant), ...]`` token grants.  Invariants the
    engine relies on: a grant that does NOT finish its prompt must be a
    positive page multiple (``seq.filled`` is page-aligned, so chunk
    boundaries stay page-aligned — the resume offsets the prefix cache can
    key on), and grants never exceed ``len(seq.req.prompt) - seq.filled``.
    Called with the shard's step lock held — no locking of its own."""

    name = "base"
    # packing marker: True → the engine executes the WHOLE plan as packed
    # fixed-shape chunks (one kernel call carrying several segments) via
    # the packed-prefill path; False → one chunk-call loop per sequence
    packs = False

    def plan(self, prefilling: Sequence, budget: int,
             page_size: int) -> List[Tuple[object, int]]:
        raise NotImplementedError


class ChunkedPrefill(SchedulerPolicy):
    """Head-of-line chunking: the oldest prefilling sequence gets the
    budget; whatever its prompt does not consume spills to the next."""

    name = "chunked"

    def plan(self, prefilling, budget, page_size):
        plan: List[Tuple[object, int]] = []
        left = budget
        for seq in prefilling:
            if left < page_size:
                break
            need = len(seq.req.prompt) - seq.filled
            grant = min(left, need)
            if grant < need:
                # mid-prompt boundary: keep it page-aligned (grant == left
                # here and left >= page_size, so this never zeroes it)
                grant -= grant % page_size
            plan.append((seq, grant))
            left -= grant
        return plan


class OneShotPrefill(SchedulerPolicy):
    """The pre-chunking baseline: whole prompts, budget ignored.  One long
    prompt stalls the decode batch for its full prefill — exactly the
    behavior the interference test shows ``chunked`` eliminates."""

    name = "oneshot"

    def plan(self, prefilling, budget, page_size):
        return [(seq, len(seq.req.prompt) - seq.filled)
                for seq in prefilling]


class RoundRobinPrefill(SchedulerPolicy):
    """Equal progress: the budget is split evenly across prefilling
    sequences (page-multiple floor, at least one page each while the budget
    lasts)."""

    name = "roundrobin"

    def plan(self, prefilling, budget, page_size):
        if not prefilling:
            return []
        share = budget // len(prefilling)
        share = max(page_size, share - share % page_size)
        plan: List[Tuple[object, int]] = []
        left = budget
        for seq in prefilling:
            if left < page_size:
                break
            need = len(seq.req.prompt) - seq.filled
            grant = min(share, left, need)
            if grant < need:
                # share and left are both >= page_size here, so the
                # aligned mid-prompt grant stays positive
                grant -= grant % page_size
            plan.append((seq, grant))
            left -= grant
        return plan


class PackedPrefill(ChunkedPrefill):
    """Packed multi-prompt prefill: grants exactly like ``chunked``
    (head-of-line with spill — the grant invariants are identical), but the
    ``packs`` marker makes the engine pack every granted sequence into one
    fixed-shape ``(1, C)`` chunk using sequence-indicator segment masks.
    The budget then buys C tokens of *aggregate* prompt progress per kernel
    call, not per sequence: a wave of short prompts admits in a single
    chunk, and the chunk-budget waste a short prompt used to leave as
    padding lanes is filled by its neighbours (the
    ``prefill_tokens_wasted`` / ``packed_segments_per_chunk`` counters in
    ``stats()`` make this observable)."""

    name = "packed"
    packs = True


SCHEDULER_POLICIES = {
    cls.name: cls for cls in (ChunkedPrefill, OneShotPrefill,
                              RoundRobinPrefill, PackedPrefill)
}


def scheduler_policies() -> List[str]:
    return list(SCHEDULER_POLICIES)


def as_scheduler_policy(policy: Union[str, SchedulerPolicy, None]
                        ) -> SchedulerPolicy:
    """Name → fresh policy instance; instances pass through; ``None`` picks
    ``chunked``."""
    if policy is None:
        return ChunkedPrefill()
    if isinstance(policy, SchedulerPolicy):
        return policy
    try:
        return SCHEDULER_POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduler policy {policy!r}; choose "
                         f"from {scheduler_policies()}") from None
