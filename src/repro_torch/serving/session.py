"""``repro_torch.serving`` sessions — many SMR domains behind one handle API
(torch port of the JAX package's ``serving/session.py``).

The paper's robustness property (a stalled thread pins O(K) objects) turns
into an architecture rule here: a :class:`ShardedEngine` gives every shard
its own ``BlockPool`` + ``PrefixCache`` + (by default) its own SMR scheme
instance, so a stall or pool-pressure event inside one shard cannot pin
pages, delay reclamation, or block admission anywhere else — the serving
restatement of Hyaline's multi-instance design (DESIGN.md §11).

Construction is one call::

    from repro_torch import serving

    session = serving.serve(model, params,
                            serving.ServingConfig(num_shards=2, smr="IBR",
                                                  eviction="lru"))
    handle = session.submit(prompt, max_new_tokens=16)
    for tok in handle:          # stream tokens as they decode
        ...
    session.close()             # drains every shard clean

Routing: the :class:`PrefixRouter` keys on the rolling-FNV hash of the
prompt's FIRST page (the same hash family the prefix cache keys entries
with), so two prompts sharing a page-aligned prefix always land on the same
shard — cross-request prefix hits survive sharding.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

from ..runtime.prefix_cache import _prefix_key
from .config import ServingConfig
from .engine import Request, _ShardEngine
from .spans import Capture
from .watchdog import SessionWatchdog

__all__ = ["PrefixRouter", "ShardedEngine", "RequestHandle",
           "ServingSession", "serve"]


class PrefixRouter:
    """Deterministic prompt → shard placement by first-page prefix key."""

    def __init__(self, num_shards: int, page_size: int):
        self.num_shards = num_shards
        self.page_size = page_size

    def shard_of(self, prompt: Sequence[int],
                 among: Optional[Sequence[int]] = None) -> int:
        """Shard for ``prompt``.  ``among`` restricts placement to a subset
        of shard ids (healthy shards, during degradation) — with ``among``
        covering all shards the answer is identical to the unrestricted
        one, so routing is unchanged while every shard is healthy."""
        if among is not None:
            if not among:
                raise ValueError("among must name at least one shard")
            if len(among) == 1:
                return among[0]
            key = _prefix_key(prompt[:self.page_size])
            mixed = (key * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
            return sorted(among)[(mixed >> 32) % len(among)]
        if self.num_shards == 1:
            return 0
        # the FNV key of the first page boundary — identical to the key the
        # prefix cache files that page under, so "same shard" and "same
        # cache bucket universe" coincide for shared prefixes.  FNV's low
        # bits are weak (short uniform prompts collapse onto one residue),
        # so Fibonacci-mix before the modulo: the placement must depend on
        # the whole 60-bit key, not its last two bits.
        key = _prefix_key(prompt[:self.page_size])
        mixed = (key * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
        return (mixed >> 32) % self.num_shards


class RequestHandle:
    """Future-style handle for one submitted request."""

    __slots__ = ("req", "shard")

    def __init__(self, req: Request, shard: int):
        self.req = req
        self.shard = shard

    # ------------------------------------------------------------- status
    @property
    def req_id(self) -> int:
        return self.req.req_id

    @property
    def status(self) -> str:
        """``waiting`` → ``prefilling`` (pages reserved, prompt chunks being
        ingested under the scheduler's token budget) → ``active`` (decoding)
        → ``done`` | ``cancelled`` | ``failed``.  Under the ``swap``
        eviction policy a request may additionally park as ``swapped``
        (preempted by a higher priority class: K/V spilled to the host
        arena, waiting to resume) before going back through
        ``prefilling``."""
        return self.req.status

    @property
    def preemptions(self) -> int:
        """Times this request was preempted to the host swap tier.
        Tokens already streamed are unaffected — resume continues
        bit-identically from where decode stopped."""
        return self.req.preemptions

    @property
    def done(self) -> threading.Event:
        return self.req.done

    @property
    def out_tokens(self) -> List[int]:
        return self.req.out_tokens

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block up to ``timeout`` seconds for the request to reach a
        terminal status; True if it did.  This is a WAIT bound on the
        caller's thread only — the request keeps running if it expires.
        A deadline on the request itself (``submit(..., timeout_s=...)``
        or ``ServingConfig.default_timeout_s``) is different: when THAT
        expires the engine cancels the request (terminal status
        ``cancelled``), releasing its pages."""
        return self.req.done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until completion; the generated tokens.  Raises
        ``TimeoutError`` if ``timeout`` expires and ``RuntimeError`` if the
        engine failed the request (drained at shutdown, shard crash, or a
        migration that found no healthy shard — ``req.error`` carries the
        diagnostic, e.g. the crash traceback)."""
        if not self.req.done.wait(timeout):
            raise TimeoutError(f"request {self.req.req_id} not done")
        if self.req.status == "failed":
            detail = f":\n{self.req.error}" if self.req.error \
                else " (engine drained before completion)"
            raise RuntimeError(f"request {self.req.req_id} failed{detail}")
        return list(self.req.out_tokens)

    def cancel(self) -> None:
        """Ask the engine to stop decoding this request.  Waiting requests
        are dropped at their next admission look; prefilling ones are
        dropped at the next step before any budget is spent on them (their
        reserved pages and hit pins go straight back); active ones finish
        their in-flight step and release their pages."""
        self.req.cancelled.set()
        self.req._progress.set()

    # ------------------------------------------------------------ latency
    def ttft(self) -> Optional[float]:
        """Time-to-first-token (seconds, submit → first emitted token);
        ``None`` until the first token exists.  With chunked prefill the
        first token streams the moment the final prompt chunk's logits
        exist — not when the whole batch's admission settles."""
        if not self.req.out_times:
            return None
        return self.req.out_times[0] - self.req.t_submit

    def itl(self) -> List[float]:
        """Inter-token latencies (seconds between consecutive emitted
        tokens); empty until two tokens exist.  The scheduler's contract is
        that each entry is bounded by one prefill chunk's work, never one
        prompt's.  Intervals spanning a preemption park or a migration
        stall are EXCLUDED — a swapped request's park time is queueing,
        not decode cadence, and it used to pollute itl_p99 as one giant
        inter-token latency.  The excluded gaps are reported by
        :meth:`gaps` (DESIGN.md §17)."""
        ts = self.req.out_times
        marks = set(self.req._gap_marks)
        return [b - a for i, (a, b) in enumerate(zip(ts, ts[1:]), start=1)
                if i not in marks]

    def gaps(self) -> List[float]:
        """Service-gap durations (seconds): each inter-token interval that
        spanned a swap preemption or a live migration, in emission order.
        ``sum(gaps())`` is the request's total parked/stalled time after
        its first token."""
        ts = self.req.out_times
        return [ts[i] - ts[i - 1] for i in self.req._gap_marks]

    def logprobs(self) -> List[float]:
        """Sampled-token log-probabilities under each step's FILTERED
        distribution, one per generated token.  Empty unless the request's
        sampling policy set ``logprobs=True`` (greedy rows report 0.0)."""
        return list(self.req.out_logprobs)

    # ------------------------------------------------------------- stream
    def tokens(self, poll_s: float = 0.05) -> Iterator[int]:
        """Stream generated tokens as the engine produces them; ends when
        the request completes (however it completes)."""
        req = self.req
        i = 0
        while True:
            out = req.out_tokens
            while i < len(out):
                yield out[i]
                i += 1
            if req.done.is_set():
                out = req.out_tokens
                while i < len(out):  # drain the tail
                    yield out[i]
                    i += 1
                return
            # event-with-timeout: a cleared-flag race just means one extra
            # poll interval, never a lost token
            req._progress.wait(poll_s)
            req._progress.clear()

    __iter__ = tokens


class _Watchdog(SessionWatchdog):
    """The session watchdog, whose heartbeat checks can be held off
    (:meth:`held`) across a pause of the whole process."""

    def __init__(self, engine, config):
        super().__init__(engine, config)
        self._held = 0
        self._hold_lock = threading.Lock()

    @contextlib.contextmanager
    def held(self):
        """Hold heartbeat checks off inside the block, which pauses the
        engine loops from outside them: ``torch.profiler``'s start, stop
        and event read keep the GIL for seconds on a busy card, and
        reading the events beside the engines starves them of it.  No
        shard is behind the others then.  On leaving, each shard's
        heartbeat clock starts anew."""
        with self._hold_lock:
            self._held += 1
        try:
            yield
        finally:
            with self._hold_lock:
                self._held -= 1
                if not self._held:
                    now = time.perf_counter()
                    self._last_change = [now] * len(self.engine.shards)

    def _heartbeat_check(self, now: float) -> None:
        with self._hold_lock:
            if not self._held:
                super()._heartbeat_check(now)


class ShardedEngine:
    """N independent shard engines + a router + a session watchdog (the
    janitor's pressure sweep, plus heartbeats / degradation / live
    migration — DESIGN.md §14)."""

    def __init__(self, model, params, config: ServingConfig, device=None):
        self.config = config
        # "shared" SMR mode: one scheme instance spans every shard (the
        # pools disambiguate frees per PageNode owner); "per_shard" (the
        # default) gives each shard its own reclamation domain
        shared = config.build_scheme() if config.shard_smr == "shared" \
            else None
        self.shards = [
            _ShardEngine(model, params, config, device=device, smr=shared,
                         shard_id=i)
            for i in range(config.num_shards)
        ]
        self.router = PrefixRouter(config.num_shards, config.page_size)
        # degraded shard ids (watchdog-maintained): excluded from routing
        # while degraded, restored on recovery
        self._degraded: set = set()
        self._dlock = threading.Lock()
        self.watchdog = _Watchdog(self, config)
        self._started = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for shard in self.shards:
            shard.start()
        self.watchdog.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.watchdog.stop(timeout)
        for shard in self.shards:
            shard.stop(drain=drain, timeout=timeout)

    # ----------------------------------------------------------- degradation
    def mark_degraded(self, shard_id: int) -> None:
        with self._dlock:
            self._degraded.add(shard_id)

    def mark_healthy(self, shard_id: int) -> None:
        with self._dlock:
            self._degraded.discard(shard_id)

    def _healthy_ids(self) -> List[int]:
        with self._dlock:
            return [i for i in range(len(self.shards))
                    if i not in self._degraded]

    def _route(self, prompt) -> int:
        """Prefix-affine placement among the healthy shards.  With every
        shard healthy this is EXACTLY the unrestricted placement (the
        restricted formula degenerates to it), so the degradation
        machinery costs nothing in routing stability.  With no healthy
        shard left, fall back to unrestricted placement rather than
        refuse: a degraded-not-crashed shard may still recover, and the
        watchdog will migrate or fail the request out if it does not."""
        healthy = self._healthy_ids()
        if len(healthy) == len(self.shards) or not healthy:
            return self.router.shard_of(prompt)
        return self.router.shard_of(prompt, among=healthy)

    # ------------------------------------------------------------- traffic
    def submit(self, req: Request) -> int:
        shard = self._route(req.prompt)
        try:
            self.shards[shard].submit(req)
            return shard
        except RuntimeError:
            # the routed shard crashed/stopped between routing and submit
            # (or the watchdog hasn't flagged it yet): try the remaining
            # healthy shards before surfacing the error
            for alt in self._healthy_ids():
                if alt == shard:
                    continue
                try:
                    self.shards[alt].submit(req)
                    return alt
                except RuntimeError:
                    continue
            raise

    def submit_many(self, reqs: Sequence[Request]) -> List[int]:
        """Route a whole admission wave, one batched ``submit_many`` per
        involved shard (one guard scope per shard, not per request)."""
        placement = [self._route(r.prompt) for r in reqs]
        by_shard: Dict[int, List] = {}
        for idx, (shard, req) in enumerate(zip(placement, reqs)):
            by_shard.setdefault(shard, []).append((idx, req))
        for shard, group in by_shard.items():
            try:
                self.shards[shard].submit_many([r for _, r in group])
            except RuntimeError:
                # shard died mid-wave; its group was NOT enqueued (the
                # engine rejects atomically) — place each request
                # individually through the retrying submit()
                for idx, req in group:
                    placement[idx] = self.submit(req)
        return placement

    def stats(self) -> List[dict]:
        return [shard.stats() for shard in self.shards]


class ServingSession:
    """The serving handle: submit prompts, stream tokens, read stats."""

    def __init__(self, model, params, config: Optional[ServingConfig] = None,
                 *, device=None, start: bool = True):
        self.config = config if config is not None else ServingConfig()
        self.engine = ShardedEngine(model, params, self.config, device)
        self._submitted = 0
        self._lock = threading.Lock()
        self._closed = False
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self.engine.start()

    def warm(self) -> None:
        """Pay every first-use cost before traffic (the kernels are built
        when the shards are made): capture the decode step's graph (a
        dense model on the card), launch each packed-prefill segment
        bucket, one speculative propose/verify round's shapes (when
        ``spec_k`` is on), and (when the swap tier is on) one page
        gather/scatter on every shard, so none of it lands on a live
        request's latency.  Each shard warms under its step lock; safe
        before or after :meth:`start`."""
        for shard in self.engine.shards:
            shard.warm_decode()
            shard.warm_packed()
            shard.warm_spec()
            shard.warm_swap()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self.engine.stop(drain=drain, timeout=timeout)

    def __enter__(self) -> "ServingSession":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------- traffic
    def _as_request(self, prompt, max_new_tokens: int, priority: int,
                    timeout_s: Optional[float],
                    priority_class: Optional[str] = None,
                    sampling=None) -> Request:
        if isinstance(prompt, Request):
            if timeout_s is not None and prompt.timeout_s is None:
                prompt.timeout_s = timeout_s
            if priority_class is not None and prompt.priority_class is None:
                prompt.priority_class = priority_class
            if sampling is not None and prompt.sampling is None:
                prompt.sampling = sampling
            return prompt
        if priority_class is not None:
            # fail unknown names on the caller's thread, before routing
            self.config.priority_class(priority_class)
        return Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                       priority=priority, timeout_s=timeout_s,
                       priority_class=priority_class, sampling=sampling)

    def submit(self, prompt: Union[Sequence[int], Request], *,
               max_new_tokens: int = 16, priority: int = 0,
               timeout_s: Optional[float] = None,
               priority_class: Optional[str] = None,
               sampling=None) -> RequestHandle:
        """Async submission: returns immediately with a
        :class:`RequestHandle` (done-event, token stream, cancel).
        ``timeout_s`` is a per-request DEADLINE (falling back to
        ``ServingConfig.default_timeout_s``): when it expires the engine
        cancels the request through the normal cancel path — terminal
        status ``cancelled``, pages released.  Distinct from the wait
        bound ``RequestHandle.wait(timeout)``, which only bounds the
        caller's blocking.  ``priority_class`` names one of
        ``ServingConfig.priority_classes``: it overrides ``priority`` and
        attaches the class's TTFT/ITL SLOs (DESIGN.md §15).
        ``sampling`` names a sampling policy (``"greedy"`` /
        ``"temperature"`` / ``"top_k"`` / ``"top_p"``) or passes a
        :class:`~repro.serving.sampling.SamplingPolicy` instance carrying
        the per-request seed, stop sequences and logprobs flag; ``None``
        is greedy — bit-identical to the pre-sampling engine
        (DESIGN.md §17)."""
        if self._closed:
            raise RuntimeError("session is closed")
        req = self._as_request(prompt, max_new_tokens, priority, timeout_s,
                               priority_class, sampling)
        shard = self.engine.submit(req)
        with self._lock:
            self._submitted += 1
        return RequestHandle(req, shard)

    def submit_many(self, prompts: Sequence[Union[Sequence[int], Request]],
                    *, max_new_tokens: int = 16, priority: int = 0,
                    timeout_s: Optional[float] = None,
                    priority_class: Optional[str] = None,
                    sampling=None) -> List[RequestHandle]:
        """Batched admission wave: per-shard grouped lookups under one SMR
        guard scope each (DESIGN.md §4)."""
        if self._closed:
            raise RuntimeError("session is closed")
        reqs = [self._as_request(p, max_new_tokens, priority, timeout_s,
                                 priority_class, sampling)
                for p in prompts]
        placement = self.engine.submit_many(reqs)
        with self._lock:
            self._submitted += len(reqs)
        return [RequestHandle(req, shard)
                for req, shard in zip(reqs, placement)]

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Structured observability snapshot: config summary, request
        counters, per-shard pool/cache/SMR counters (including the paper's
        ``anchor_recoveries``/``wf_escalations`` mechanism counters inside
        ``prefix_cache.traversal``), and cross-shard totals."""
        shards = self.engine.stats()
        totals: Dict[str, float] = {
            "steps": sum(s["steps"] for s in shards),
            "active": sum(s["active"] for s in shards),
            "prefilling": sum(s["prefilling"] for s in shards),
            "waiting": sum(s["waiting"] for s in shards),
            "completed": sum(s["completed"] for s in shards),
            "cancelled": sum(s["cancelled"] for s in shards),
            "failed": sum(s["failed"] for s in shards),
            "pool_free": sum(s["pool"]["free"] for s in shards),
            "prefix_hits": sum(s["prefix_cache"]["hits"] for s in shards),
            "prefix_entries": sum(s["prefix_cache"]["entries"]
                                  for s in shards),
            "prefill_chunks": sum(s["prefill_chunks"] for s in shards),
            "prefill_tokens_wasted": sum(s["prefill_tokens_wasted"]
                                         for s in shards),
            "packed_chunks": sum(s["packed_chunks"] for s in shards),
            "packed_segments": sum(s["packed_segments"] for s in shards),
            "rider_chunks": sum(s["rider_chunks"] for s in shards),
            "decode_steps": sum(s["decode_steps"] for s in shards),
            "decode_graph_replays": sum(s["decode_graph_replays"]
                                        for s in shards),
            # fault-tolerance counters (DESIGN.md §14): migrations counts
            # completed handoffs (in == out when no handoff is mid-flight)
            "migrations": sum(s["migrated_out"] for s in shards),
            "heartbeat_misses": sum(s["heartbeat_misses"] for s in shards),
            "degraded_steps": sum(s["degraded_steps"] for s in shards),
            "failed_requests": sum(s["failed"] for s in shards),
            "crashed_shards": sum(1 for s in shards if s["crashed"]),
            "degraded_shards": sum(1 for s in shards if s["degraded"]),
            # swap tier + priority-class SLOs (DESIGN.md §15)
            "preemptions": sum(s["preemptions"] for s in shards),
            "resumed": sum(s["resumed"] for s in shards),
            "slo_cancelled": sum(s["slo_cancelled"] for s in shards),
            "itl_slo_violations": sum(s["itl_slo_violations"]
                                      for s in shards),
            "gap_intervals": sum(s["gap_intervals"] for s in shards),
            "gap_seconds": sum(s["gap_seconds"] for s in shards),
            # speculative decoding (DESIGN.md §17)
            "draft_proposed": sum(s["draft_proposed"] for s in shards),
            "draft_accepted": sum(s["draft_accepted"] for s in shards),
            "spec_rounds": sum(s["spec_rounds"] for s in shards),
            "swapped_out": sum(s["swap"]["swapped_out"] for s in shards
                               if s["swap"] is not None),
            "swapped_in": sum(s["swap"]["swapped_in"] for s in shards
                              if s["swap"] is not None),
            "swap_bytes_used": sum(s["swap"]["bytes_used"] for s in shards
                                   if s["swap"] is not None),
        }
        # the serving loop's counters and span totals (serving/spans.py)
        for key in ("prefill_tokens_computed", "decode_rows",
                    "decode_kv_tokens", "fused_blocks", "eager_blocks",
                    "mla_prefill_rows", "mla_prefill_keys",
                    "moe_decode_passes", "moe_decode_local_pairs",
                    "lru_flushes", "lru_flushed_stamps"):
            totals[key] = sum(s[key] for s in shards)
        for s in shards:
            for name, (n, sec) in s["spans"].items():
                totals[f"span_n.{name}"] = totals.get(f"span_n.{name}",
                                                      0) + n
                totals[f"span_s.{name}"] = totals.get(f"span_s.{name}",
                                                      0.0) + sec
        # chunk-weighted mean across shards (NOT a mean of per-shard means)
        totals["packed_segments_per_chunk"] = (
            totals["packed_segments"] / totals["packed_chunks"]
            if totals["packed_chunks"] else 0.0)
        # proposal-weighted accept rate (NOT a mean of per-shard rates)
        totals["accept_rate"] = (
            totals["draft_accepted"] / totals["draft_proposed"]
            if totals["draft_proposed"] else 0.0)
        with self._lock:
            submitted = self._submitted
        return {
            "config": self.config.summary(),
            "requests": {"submitted": submitted,
                         "completed": int(totals["completed"]),
                         "cancelled": int(totals["cancelled"]),
                         "failed": int(totals["failed"])},
            "shards": shards,
            "totals": totals,
        }


    # ------------------------------------------------------------ profile
    def profile(self, seconds: float, path) -> dict:
        """Capture ``seconds`` of serving: the device's kernels and the
        CUDA runtime calls (``torch.profiler``; on the CPU, every
        thread's operations) with the program's spans, on the host's
        ``perf_counter`` clock, written as one Chrome trace to ``path``.

        The calling thread starts and stops the profiler.  Shard 0's
        engine thread opens the capture between steps, under its step
        lock, and brackets it with two anchors, launches stamped on the
        host clock; the offset from the profiler's clock is read from
        them.  The profiler's start and stop keep the GIL for seconds on
        a busy card, pausing every thread of the process, the engines
        too (``stop_s``; ``beats_in_stop`` counts shard 0's loop turns
        meanwhile), and reading its events beside the engines slows
        them: the watchdog's heartbeat checks are held across the
        profiler's start and from its stop to the summary, while request
        deadlines and SLO clocks run on.

        Returns a summary: the device's busy and idle share between the
        anchors, idle device time by the innermost span open on that
        engine thread (``idle_by_span``; ``(no span)`` where none), each
        engine span's self time (``self_by_span``), both anchors'
        offsets and their difference (``drift_ns``), the spans in the
        trace; on the card, the share of the engine thread's kernel
        launches made inside a step span and its runtime calls that wait
        for the device by span (``syncs_by_span``); and the load: decode
        calls, ``decode_rows``, ``decode_kv_tokens`` and
        ``prefill_tokens_computed`` over the capture.  Raises
        ``RuntimeError`` while another profiler records, or when the
        engine thread is not running."""
        held = self.engine.watchdog.held
        cap = Capture(self.engine.shards, seconds)
        with held():
            cap.begin()
        closed, out = False, None
        try:
            self.engine.shards[0].open_capture(cap)
            # the engine closes the capture at its first step after
            # ``seconds`` (a step takes well under a second)
            closed = cap.closed.wait(seconds + 300.0)
        finally:
            with held():
                cap.end()
                if closed and cap.error is None:
                    out = cap.reduce(path)
        if not closed:
            raise TimeoutError("the engine thread did not end the capture")
        if cap.error is not None:
            raise cap.error
        return out


def serve(model, params, config: Optional[ServingConfig] = None, *,
          device=None, start: bool = True, **overrides) -> ServingSession:
    """Open a serving session — THE construction surface for serving.

    ``config`` may be omitted and built from keyword overrides
    (``serve(model, params, num_shards=2, eviction="lru")``), or passed and
    refined (``serve(model, params, cfg, max_batch=8)``).

    ``device=None`` serves on the card (``"cuda"``) and raises where there
    is none; ``device="cpu"`` runs the plain PyTorch versions of the
    kernels.  ``params`` must already live on that device in the config's
    dtype (``model.init(seed, device=...)`` or ``from_jax_params``).
    """
    if config is None:
        config = ServingConfig(**overrides)
    elif overrides:
        config = config.replace(**overrides)
    return ServingSession(model, params, config, device=device, start=start)
