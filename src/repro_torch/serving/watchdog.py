"""Shard watchdog: heartbeats, graceful degradation, and SMR-safe live
sequence migration (DESIGN.md §14).

The per-shard SMR domains of :class:`~repro.serving.session.ShardedEngine`
already bound the *memory* a stalled shard can pin (O(K) pages of its own
pool).  This module bounds the *liveness* damage: one session maintenance
thread (the PR-4 janitor, reworked) sweeps pool pressure AND watches each
shard's loop heartbeat.  A shard that stops beating past
``ServingConfig.heartbeat_timeout_s`` is marked **degraded**: the router
stops placing new prompts on it, and (in ``watchdog="migrate"`` mode) its
queued/prefilling/active sequences are live-migrated to healthy shards.

Migration protocol (the cross-domain reclamation exercise from ROADMAP
item 2; ordering proved safe in DESIGN.md §14):

1. the replay prompt is the request's host-side token stream (prompt +
   tokens already emitted, ``Request.fold_emitted``) — emitted tokens are
   TEACHER-FORCED: the target re-ingests the recorded ids as prompt
   tokens and never re-samples them, and every FRESH position draws from
   the stateless counter PRNG keyed by (request seed, absolute position),
   so the continuation is token-exact under ANY sampling policy, not just
   greedy (DESIGN.md §17); KV page *contents* never cross domains;
2. the TARGET shard pins its own prefix-cache hit for the replay prompt
   (``_ShardEngine.receive_migrated`` → ``BlockPool.import_claim``) and
   enqueues the request — pages re-pinned in the target domain FIRST;
3. only then is the SOURCE domain's claim retired
   (``BlockPool.export_claim``: owned pages released, hit pins dropped) —
   no window where neither domain pins the request's pages, and no
   cross-domain ABA because a PageNode never leaves its pool.

Live sequences (prefilling/active) are only stolen under the source's step
lock, acquired with exponential backoff — a shard stalled *inside* a step
still owns its lists.  If the lock never comes (the crash path), the
stranded requests' handles are failed out so no client hangs, their
``cancelled`` event is set so a later-resuming engine releases the pages
through the normal cancel path, and the pages stay pinned in the stalled
domain in the meantime — exactly the paper's bounded-damage contract.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

__all__ = ["SessionWatchdog"]


class SessionWatchdog:
    """One maintenance thread per session: pressure sweep (the old
    janitor duty), heartbeat checks, degradation bookkeeping, and live
    migration off degraded shards."""

    def __init__(self, engine, config):
        self.engine = engine        # ShardedEngine
        self.config = config
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        n = len(engine.shards)
        self._last_beat = [-1] * n
        self._last_change = [0.0] * n
        self._migrate_attempts = [0] * n
        self._last_hb_check = 0.0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        now = time.perf_counter()
        self._last_change = [now] * len(self.engine.shards)
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-watchdog", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # ----------------------------------------------------------------- loop
    def _loop(self) -> None:
        interval = min(self.config.janitor_interval_s,
                       self.config.watchdog_interval_s)
        while not self._stop.wait(interval):
            self._pressure_sweep()
            if self.config.watchdog == "off":
                continue
            now = time.perf_counter()
            if now - self._last_hb_check >= self.config.watchdog_interval_s:
                self._last_hb_check = now
                self._heartbeat_check(now)
            if self.config.watchdog == "migrate":
                self._migrate_degraded(time.perf_counter())

    def _pressure_sweep(self) -> None:
        """The PR-4 janitor duty: when a shard's pool cannot cover one more
        admission, shed that shard's eviction quota and help its
        reclamation — from OUTSIDE the shard's engine thread, so a shard
        stuck in a long decode still gets pages freed."""
        for shard in self.engine.shards:
            if shard.pool.free_count() < shard.max_pages:
                shard.prefix_cache.pressure_evict()
                shard.smr.help_reclaim()

    # ------------------------------------------------------------ heartbeat
    def _heartbeat_check(self, now: float) -> None:
        for i, shard in enumerate(self.engine.shards):
            beat = shard.beat
            if shard.crashed:
                if not shard.degraded:
                    self._degrade(shard)
                continue
            if beat != self._last_beat[i]:
                self._last_beat[i] = beat
                self._last_change[i] = now
                if shard.degraded:
                    # the loop advanced again: recovered — route traffic
                    # back (a crashed shard never recovers)
                    shard.degraded = False
                    self.engine.mark_healthy(shard.shard_id)
                    self._migrate_attempts[i] = 0
            elif not shard.degraded and \
                    now - self._last_change[i] > \
                    self.config.heartbeat_timeout_s:
                shard.heartbeat_misses += 1
                self._degrade(shard)

    def _degrade(self, shard) -> None:
        shard.degraded = True
        self.engine.mark_degraded(shard.shard_id)

    # ------------------------------------------------------------ migration
    def _healthy_targets(self) -> List:
        return [s for s in self.engine.shards
                if not s.degraded and not s.crashed]

    def _migrate_degraded(self, now: float) -> None:
        if not self._healthy_targets():
            # nowhere to move work: leave it in place.  A degraded-but-
            # alive shard may recover and serve its own queue (first-
            # traffic jit compiles degrade EVERY shard at once on a slow
            # box — stealing then would mass-fail requests that are about
            # to complete); per-request deadlines still bound the wait.
            return
        for i, shard in enumerate(self.engine.shards):
            if not shard.degraded or shard.crashed:
                # a crashed shard's crash guard already failed everything
                # out — migrating against its drain would race the
                # pool-clean assertion for requests that are dead anyway
                continue
            # the waiting queue is safe from any thread (queue lock only)
            reqs = shard.steal_waiting()
            for req in reqs:
                self._migrate_request(shard, req, now)
            if not (shard._prefilling or shard._active):
                continue
            # live sequences need the step lock: exponential backoff across
            # sweeps, then the crash path for a shard wedged IN a step
            attempt = self._migrate_attempts[i]
            timeout = self.config.migration_backoff_s * (2 ** attempt)
            seqs = shard.steal_live(timeout=timeout)
            if seqs is None:
                self._migrate_attempts[i] = attempt + 1
                if attempt + 1 >= self.config.migration_max_retries:
                    self._fail_unstealable(shard)
                continue
            self._migrate_attempts[i] = 0
            for seq in seqs:
                self._migrate_request(shard, seq.req, now, seq=seq)

    def _migrate_request(self, source, req, now: float, seq=None) -> None:
        """One request's SMR-safe handoff: target re-pin BEFORE source
        retire (module docstring, step 2 then 3)."""
        # the source domain's current claim — saved BEFORE the target's
        # _attach_hit overwrites the request's hit fields
        src_hits = list(req._hit_pages)
        src_owned = list(seq.pages[seq.owned_from:]) if seq is not None \
            else []
        if seq is not None:
            # seq.pages[:owned_from] are the admission hit pins — the same
            # nodes as req._hit_pages, already in src_hits
            req._hit_pages, req._hit_tokens = [], 0

        def retire_source():
            source.pool.export_claim(src_hits, src_owned)
            # a swapped request's arena bytes are redundant once another
            # domain owns it (the replay prompt recomputes them there) —
            # discard the manifest so the source arena's slots free up
            source._release_swap(req)

        if req.cancelled.is_set() or \
                (req.deadline is not None and now > req.deadline):
            # expired/cancelled on a stalled shard: the engine there can't
            # run the cancel path — the watchdog does, releasing the claim
            retire_source()
            req.status = "cancelled"
            source.n_cancelled += 1
            req._progress.set()
            req.done.set()
            return
        # replay prompt: decode-active sequences replay their emitted
        # tokens through the target's prefill — the recorded ids are
        # teacher-forced as prompt tokens (never re-sampled), and fresh
        # positions re-enter the counter PRNG at the same (seed, absolute
        # position) keys, so the continuation is token-exact under any
        # sampling policy (DESIGN.md §17).  fold_emitted's cursor makes
        # this idempotent — a request migrated (or preempted) twice must
        # not fold its first leg's tokens twice.
        req.fold_emitted()
        # the next token after adoption closes a migration-stall gap, not
        # an inter-token latency: mark it for the ITL gap accounting
        req._gap_pending = True
        targets = self._healthy_targets()
        # prefix-affine placement among the healthy shards only
        order = []
        if targets:
            pick = self.engine.router.shard_of(
                req.prompt, among=[t.shard_id for t in targets])
            by_id = {t.shard_id: t for t in targets}
            order = [by_id[pick]] + [t for t in targets
                                     if t.shard_id != pick]
        for target in order:
            try:
                target.receive_migrated(req)   # pins target domain + enqueue
            except RuntimeError:
                continue                        # target closing: try next
            retire_source()                     # now retire source's claim
            source.n_migrated_out += 1
            return
        # no healthy target: fail out cleanly rather than strand the handle
        retire_source()
        req.error = (f"shard {source.shard_id} degraded and no healthy "
                     f"shard could adopt the request")
        req.status = "failed"
        source.n_failed += 1
        req._progress.set()
        req.done.set()

    def _fail_unstealable(self, shard) -> None:
        """Crash path for a shard wedged INSIDE a step (step lock never
        acquired): fail the handles so no client hangs; set ``cancelled``
        so the engine, if it ever resumes, releases the pages through the
        normal cancel path.  Until then the pages stay pinned in the
        stalled domain — bounded damage, the paper's contract."""
        for seq in list(shard._prefilling) + list(shard._active):
            req = seq.req
            if req.done.is_set():
                continue
            req.error = (f"shard {shard.shard_id} stalled mid-step; "
                         f"migration handoff timed out after "
                         f"{self.config.migration_max_retries} retries")
            req.cancelled.set()
            req.status = "failed"
            shard.n_failed += 1
            req._progress.set()
            req.done.set()
