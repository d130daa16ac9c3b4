"""Prefix cache on SCOT structures — the paper's data structures on the
serving hot path.

Every request admission does a *read-only optimistic lookup* (Harris' list
per bucket, SCOT-validated) of its prompt's page-aligned prefixes; hits
reuse the cached KV pages directly in the new sequence's block table.  The
Harris-vs-Harris-Michael throughput gap the paper measures (Fig. 8) is the
admission-latency gap here; the NM-tree variant indexes prefixes *ordered*
so eviction can scan ranges.

Lookup is **single-pass** (DESIGN.md §4): the per-candidate FNV hash — which
restarted from the first token for every prefix length, O(n²) in prompt
tokens — is replaced by one rolling pass that emits every page boundary's
key, and all candidates resolve under ONE ``guard_batch`` scope.  Under
cumulative schemes (the serving default, IBR) candidates are grouped per
bucket and each involved bucket is traversed once (sorted, resumed), longest
-max bucket first with an early exit once no remaining bucket can beat the
best validated hit; one-shot schemes (HP/HE) fall back to a per-candidate
longest-first probe that still amortizes the guard and the hashing.

Entries reference :class:`PageNode` runs; pages are pinned while cached, and
retired through the same SMR instance when evicted — so a concurrent lookup
that already protected an entry can safely finish reading its page run even
as the eviction proceeds (no page is recycled under it)."""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple, Union

from .. import api
from ..core.atomics import AtomicInt
from ..core.smr.base import SmrScheme, ThreadCtx
from ..core.structures.traversal import UNSET
from .block_pool import BlockPool, PageNode
from .eviction import EvictionPolicy, as_eviction_policy

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK60 = (1 << 60) - 1


def _prefix_key(tokens: Sequence[int]) -> int:
    """Stable 60-bit hash of a token prefix (reference implementation; the
    rolling variant below must agree with it — property-tested)."""
    h = _FNV_OFFSET
    for t in tokens:
        h = ((h ^ (int(t) + 1)) * _FNV_PRIME) & _MASK60
    return h


def _rolling_prefix_keys(tokens: Sequence[int], page_size: int,
                         n_pages: int) -> List[int]:
    """Keys of ALL page-aligned prefixes in ONE pass over the tokens.

    ``out[i] == _prefix_key(tokens[:(i+1)*page_size])`` — the FNV state at a
    page boundary is exactly the hash of that prefix, so emitting it while
    rolling forward replaces the per-candidate restart (O(n²) → O(n))."""
    out: List[int] = []
    if n_pages <= 0:
        return out
    h = _FNV_OFFSET
    boundary = page_size
    i = 0
    for t in tokens:  # single pass, no per-page slicing
        h = ((h ^ (int(t) + 1)) * _FNV_PRIME) & _MASK60
        i += 1
        if i == boundary:
            out.append(h)
            if len(out) == n_pages:
                break
            boundary += page_size
    return out


class PrefixCache:
    """Bucketed SCOT lists mapping prefix-hash → (pages, n_tokens)."""

    def __init__(self, smr: SmrScheme, pool: BlockPool, page_size: int,
                 num_buckets: int = 64, optimistic=UNSET,
                 max_entries: int = 4096, traversal=None,
                 eviction: Union[str, EvictionPolicy, None] = None):
        self.smr = smr
        self.pool = pool
        self.page_size = page_size
        self.num_buckets = num_buckets
        self.max_entries = max_entries
        if optimistic is not UNSET:
            if traversal is not None:
                raise TypeError("PrefixCache: pass either traversal= or "
                                "the deprecated optimistic= flag, not both")
            warnings.warn("PrefixCache(optimistic=...) is deprecated; pass "
                          "traversal='hm' for the Harris-Michael buckets",
                          DeprecationWarning, stacklevel=2)
            traversal = None if optimistic else "hm"
        structure = "HMList" if (traversal is not None and
                                 api.as_policy(traversal).careful) else "HList"
        # negotiate once, then build every bucket through the facade
        self.policy = api.check(structure, smr, traversal)
        self.buckets = [api.build(structure, smr=smr, traversal=self.policy)
                        for _ in range(num_buckets)]
        self.n_entries = AtomicInt(0)
        self.n_hits = AtomicInt(0)
        self.n_misses = AtomicInt(0)
        # named eviction policy (fifo/pressure/lru) — owns the victim index
        # (the FIFO ring / the NM-tree LRU index) and the pressure quota
        self.eviction = as_eviction_policy(eviction)
        self.eviction.bind(self)

    def _bucket(self, key: int):
        return self.buckets[key % self.num_buckets]

    # ------------------------------------------------------------ lookup
    def lookup(self, tokens: Sequence[int]) -> Tuple[List[PageNode], int]:
        """Longest page-aligned cached prefix of ``tokens``.

        Read-only optimistic traversal (zero CAS on hit path), single
        rolling-hash pass, one guard scope for all candidate lengths.
        Returned pages are pinned for the caller (caller must unpin when its
        block table no longer references them)."""
        n_pages = len(tokens) // self.page_size
        if n_pages == 0:
            self.n_misses.fetch_add(1)
            return ([], 0)
        with self.smr.guard_batch(n_pages) as ctx:
            pages, n_tok, hit_key = self._resolve_longest(tokens, n_pages,
                                                          ctx)
        if n_tok:
            self.n_hits.fetch_add(1)
            # recency signal OUTSIDE the guard scope (the LRU policy opens
            # its own guard on the index tree; nesting scopes on one scheme
            # would reset the outer reservations)
            self.eviction.record_use(hit_key)
        else:
            self.n_misses.fetch_add(1)
        return (pages, n_tok)

    def lookup_many(self, prompts: Sequence[Sequence[int]]
                    ) -> List[Tuple[List[PageNode], int]]:
        """Batched admission: every prompt's lookup under ONE guard scope
        (one reservation lifecycle for the whole admission wave)."""
        if not prompts:
            return []
        results: List[Tuple[List[PageNode], int]] = []
        hit_keys: List[int] = []
        with self.smr.guard_batch(len(prompts)) as ctx:
            for tokens in prompts:
                n_pages = len(tokens) // self.page_size
                if n_pages == 0:
                    best = ([], 0, None)
                else:
                    best = self._resolve_longest(tokens, n_pages, ctx)
                if best[1]:
                    self.n_hits.fetch_add(1)
                    hit_keys.append(best[2])
                else:
                    self.n_misses.fetch_add(1)
                results.append(best[:2])
        for key in hit_keys:  # outside the guard (see lookup())
            self.eviction.record_use(key)
        return results

    def _probe(self, key: int, np_: int, ctx: ThreadCtx
               ) -> Optional[Tuple[List[PageNode], int]]:
        """Try one candidate: find, pin its run, validate liveness.

        Validation is SCOT one level up (DESIGN.md §2): pin the entry's
        pages, then re-check the entry node is still live (unmarked).  If
        eviction raced us, unpin and report a miss — pins on recycled
        pages are inert by construction."""
        node = self._bucket(key).get_node(key, ctx)
        if node is None:
            return None
        pool = self.pool
        pages = list(node.value)  # entry node protected ⇒ safe read
        for p in pages:
            pool.pin(p)
        if node.next_ref().get_mark():
            for p in pages:
                pool.unpin(p)
            return None
        return (pages, np_ * self.page_size)

    def _resolve_longest(self, tokens: Sequence[int], n_pages: int,
                         ctx: ThreadCtx
                         ) -> Tuple[List[PageNode], int, Optional[int]]:
        """Longest validated page-aligned candidate ``(pages, n_tok, key)``,
        under the caller's guard scope (``key`` feeds the eviction policy's
        recency index — outside the scope)."""
        pool = self.pool
        # ONE rolling pass over the tokens emits every boundary's key (the
        # pre-batching loop re-hashed from token 0 per candidate — O(n²)).
        keys = _rolling_prefix_keys(tokens, self.page_size, n_pages)
        # Fast path for the hot cache: the LONGEST candidate usually exists
        # (insert caches every page-aligned prefix), and a validated hit on
        # it beats every other candidate by construction — probe it before
        # building any per-bucket grouping.
        hit = self._probe(keys[-1], n_pages, ctx)
        if hit is not None:
            return (hit[0], hit[1], keys[-1])
        keys = keys[:-1]
        if not keys:
            return ([], 0, None)
        if not self.smr.cumulative_protection:
            # One-shot schemes (HP/HE): a node found in bucket A loses its
            # hazard-slot protection once we traverse bucket B, so resolve
            # per candidate, longest first — still one guard scope and one
            # hashing pass for the whole loop.
            for np_ in range(len(keys), 0, -1):
                hit = self._probe(keys[np_ - 1], np_, ctx)
                if hit is not None:
                    return (hit[0], hit[1], keys[np_ - 1])
            return ([], 0, None)
        # Cumulative schemes (EBR/IBR/HLN/NR): everything observed inside
        # the scope stays protected until it exits, so group candidates by
        # bucket and walk each involved bucket ONCE (sorted resumed
        # traversal).  Buckets ordered by their longest candidate, with an
        # early exit once no remaining bucket can beat the best hit — a
        # fully-cached prompt touches exactly one bucket.
        by_bucket: dict = {}
        for np_, key in enumerate(keys, 1):
            by_bucket.setdefault(key % self.num_buckets, []).append((np_, key))
        best_pages: List[PageNode] = []
        best_np = 0
        best_key: Optional[int] = None
        for bidx, cands in sorted(by_bucket.items(),
                                  key=lambda kv: kv[1][-1][0], reverse=True):
            if cands[-1][0] <= best_np:
                break  # no remaining bucket holds a longer candidate
            bkeys = sorted(key for _, key in cands)
            nodes = self.buckets[bidx].get_nodes(bkeys, ctx)
            found = dict(zip(bkeys, nodes))
            for np_, key in reversed(cands):  # longest candidate first
                if np_ <= best_np:
                    break
                node = found.get(key)
                if node is None:
                    continue
                pages = list(node.value)
                for p in pages:
                    pool.pin(p)
                if node.next_ref().get_mark():
                    for p in pages:
                        pool.unpin(p)
                    continue
                # a longer hit supersedes the previous best — release the
                # pins we took on the superseded run, or they leak forever
                for p in best_pages:
                    pool.unpin(p)
                best_pages, best_np, best_key = pages, np_, key
                break
        if best_np:
            return (best_pages, best_np * self.page_size, best_key)
        return ([], 0, None)

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], pages: Sequence[PageNode]) -> None:
        """Cache every page-aligned prefix of a finished sequence (one entry
        per page boundary, so any future prompt can hit its longest match).
        One rolling-hash pass and one guard scope for all entries."""
        n_pages = min(len(tokens) // self.page_size, len(pages))
        if n_pages == 0:
            return
        keys = _rolling_prefix_keys(tokens, self.page_size, n_pages)
        added: List[Tuple[int, int]] = []
        with self.smr.guard_batch(n_pages) as ctx:
            for np_ in range(1, n_pages + 1):
                key = keys[np_ - 1]
                run = list(pages[:np_])
                for p in run:
                    self.pool.pin(p)
                if self._bucket(key).insert(key, run, ctx):
                    self.n_entries.fetch_add(1)
                    added.append((key % self.num_buckets, key))
                else:
                    for p in run:  # lost the race; someone already cached it
                        self.pool.unpin(p)
        for bidx, key in added:  # outside the guard (LRU opens its own)
            self.eviction.record_insert(bidx, key)
        self._maybe_evict()

    # ------------------------------------------------------------ evict
    def _maybe_evict(self) -> None:
        while self.n_entries.load() > self.max_entries:
            if not self.evict_oldest(1):
                return

    def evict_oldest(self, n: int = 1) -> int:
        """Evict up to n entries in the policy's victim order (fifo /
        pressure: insertion order; lru: least-recently-used); returns the
        count actually evicted.  A stale victim (its entry already evicted
        by a racing caller) does not burn the budget — the next one is
        tried instead, so ``_maybe_evict`` cannot stall above
        ``max_entries`` behind stale index slots."""
        done = 0
        while done < n:
            key = self.eviction.next_victim()
            if key is None:
                break
            if self.evict(key):
                done += 1
        return done

    def pressure_evict(self) -> int:
        """Pool-pressure response: evict the policy's quota for one event
        (replaces the engine's hardcoded ``evict_oldest(4)``)."""
        return self.evict_oldest(self.eviction.pressure_quota(self,
                                                              self.pool))

    def clear(self) -> int:
        """Teardown sweep (engine ``stop()`` drain): evict every entry so
        all cache pins are dropped.  Drains the policy's victim index, then
        sweeps the buckets directly for any entry the index lost track of
        (e.g. a victim consumed by a racing evictor that then failed).
        Caller must have quiesced concurrent inserts."""
        n = 0
        while True:
            key = self.eviction.next_victim()
            if key is None:
                break
            if self.evict(key):
                n += 1
        for bucket in self.buckets:
            for key in list(bucket.snapshot()):
                if self.evict(key):
                    n += 1
        return n

    def evict(self, key: int) -> bool:
        bucket = self._bucket(key)
        # recency token BEFORE the pop: forget() below must only drop the
        # index state of the incarnation we actually removed — a racing
        # re-insert of the same key stamps a newer token and keeps its slot
        token = self.eviction.peek(key)
        # pop() tells us exactly WHICH node we removed, so we unpin exactly
        # the page run that entry referenced — a lookup-then-delete pair
        # could observe one entry and delete a concurrently re-inserted
        # successor, unpinning the wrong run
        with self.smr.guard() as ctx:
            node = bucket.pop(key, ctx)
            pages = list(node.value) if node is not None else []
        if node is not None:
            self.n_entries.fetch_add(-1)
            for p in pages:
                self.pool.unpin(p)
            self.eviction.forget(key, token)  # drop THIS incarnation's state
            return True
        # Lost the delete race: the entry was already removed (its winner
        # unpinned the pages), and any concurrent RE-insert enqueues its own
        # ring slot — nothing to re-queue here.  The caller (evict_oldest)
        # just moves on to the next slot instead of burning its budget.
        return False

    def stats(self):
        # aggregate the bucket structures' traversal counters (restarts,
        # validation failures, and the wait-free anchor_recoveries /
        # wf_escalations) so per-shard serving stats surface the paper's
        # mechanism counters without reaching into buckets
        traversal: dict = {}
        for bucket in self.buckets:
            for k, v in bucket.stats().items():
                traversal[k] = traversal.get(k, 0) + v
        return {
            "entries": self.n_entries.load(),
            "hits": self.n_hits.load(),
            "misses": self.n_misses.load(),
            "eviction": self.eviction.name,
            "traversal": traversal,
        }
