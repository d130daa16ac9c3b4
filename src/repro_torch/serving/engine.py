"""Shard engine — continuous batching with chunked prefill over one
SMR-managed pool (torch port of the JAX package's ``serving/engine.py``).

The paper bounds the blast radius of one stalled participant (a stalled
thread pins O(1) unreclaimed nodes); the step loop applies the same rule to
prompt ingestion.  Admission only *reserves* pages and enqueues the sequence
in a ``prefilling`` state; each ``step()`` spends at most
``ServingConfig.prefill_chunk_tokens`` advancing prefill chunks (divided by
the named scheduler policy) and then runs the batched decode for every
in-flight sequence — so admitting a 4k-token prompt delays active decoders
by one chunk of work, never one prompt (DESIGN.md §12).

Thread roles (this is where the paper's concurrency actually happens):
  * client threads: ``submit()`` does the *optimistic prefix-cache lookup*
    (SCOT Harris-list traversal) and pins any hit pages;
  * the shard's engine thread: admission (via the named admission policy),
    chunked paged prefill (via the named scheduler policy), batched paged
    decode (kernels/ops.paged_attention), page alloc/release;
  * the session janitor thread: evicts prefix entries under pool pressure
    (retiring entry nodes and unpinning pages through the SMR scheme).

A page freed by the SMR is recycled to another sequence — if any of the
above threads still held an unprotected reference, decode would read another
request's KV (the serving-world version of Figure 1's SEGFAULT).  The SMR +
SCOT discipline prevents exactly that; the port's tests check that paged
outputs equal the contiguous-cache reference decode, token for token.

The engine keeps the host side (operands, embedding, the logits, sampling,
scheduling, page allocation, the prefix cache).  The pool's format and the
decoder blocks over it are the shard's stack (``serving/paged_stack.py``):
dense decoders (GQA attention, SwiGLU FFN) over a K/V pair, MLA decoders
(DeepSeek-V2) over one latent pool, which takes no speculative decoding,
host swap tier or live migration (the shard refuses them when it is made).

What differs from the reference, all on the device side (the host logic is
the reference's):

* The pool is updated IN PLACE on the engine's device (the reference
  donates its buffers to ``jit``); PyTorch runs eagerly, and a dense
  block's elementwise chain runs as fused kernels
  (``kernels/fused_block.py``) where XLA fuses it.
* Masked writes: every lane carries a write target, and a padding lane
  or an unoccupied row carries page -1, which writes nothing: it never
  touches a page, shared or recycled (the reference scatters them out of
  bounds with ``mode="drop"``).
* Every prefill chunk runs one device function, ``_paged_prefill_packed``:
  the ``chunked`` scheduler's chunk is a packed chunk with one segment.
  The packed scheduler always takes the (segments x max_pages) rectangle
  with its power-of-two segment bucket; the reference's kernel-less ragged
  layout (``_paged_step_packed_flat``) is not ported.
* The fused packed step runs its decode riders as the decode step
  (products at max_batch rows, ``ops.paged_attention`` with the decode
  step's split count) beside the prefill chunk, which is C lanes wide;
  the reference lays each rider into a C + max_batch chunk as a one-lane
  segment.  A generated position's bytes then do not depend on whether
  its row rode a prefill chunk.
* Sampling draws JAX's threefry bits (``kernels/ref.py``), so a seeded
  request samples the tokens the reference engine samples; the sampler and
  the speculative accept rule are plain tensor math on the device, as in
  the reference (neither has a Pallas kernel there).
* Speculative decoding: the draft re-prefills densely over the batch's
  token buffer trimmed to its longest stream rounded up to a page (the
  reference pads to ``max_pages * page_size``; the trim gives the same
  rows at a fraction of the score tensor), and the verify chunk of
  ``max_batch * (spec_k + 1)`` lanes (dead lanes interleaved) attends
  through ``ops.paged_attention``, one paged row per lane with the decode
  step's split count (the reference attends it as packed prefill): a lane
  sums its keys in the decode step's order, so in bf16 an accepted
  position's K/V bytes are the plain decode path's.  A greedy row takes
  its first token from the prefill chunk, as plain greedy does (the
  reference draws it in the first spec round, recomputing the last
  prompt position in a verify lane); sampled rows follow the reference.
* The host swap tier moves a victim's pages with one batched gather and
  one synchronous device-to-host copy (the reference loops page by page);
  bf16 pages travel as their 16-bit patterns (the arena holds ``uint16``),
  since the copied arena module sizes its buffers with numpy dtypes.  The
  partly filled last page spills too, and a fully restored sequence
  resumes straight into decode (the reference re-ingests the tail by
  prefill): the port's prefill and decode kernels round differently, and
  this keeps a resumed stream bit-exact on the card.
* Live migration carries a decoding sequence's pages to the target shard
  the same way (``steal_live`` copies them to the host under the source's
  step lock, the target's admission scatters them into its own pages and
  resumes the sequence straight into decode); the reference re-ingests
  the folded tokens by prefill on the target, which in bf16 on the card
  moved a migrated stream off its uninterrupted run.  Queued and
  prefilling requests still migrate by re-prefill.
* Kernels are built when the shard is constructed (``ops.prepare``), never
  inside a step, where a first build would hold the step lock and read as
  a stall to the watchdog.  :meth:`_ShardEngine.warm_packed`,
  :meth:`~_ShardEngine.warm_spec` and :meth:`~_ShardEngine.warm_swap` run
  each remaining first-use path once (``ServingSession.warm``).

One :class:`_ShardEngine` is one SMR domain: in a :class:`ShardedEngine`
session each shard owns its own pool + prefix cache + (by default) its own
scheme instance, so a stalled thread pins O(K) pages *of one shard* and the
others keep reclaiming — the paper's robustness property applied as an
architecture decision (DESIGN.md §11).

:class:`PagedServingEngine` survives one release as a ``DeprecationWarning``
shim mapping the old kwargs onto :class:`ServingConfig`; new code goes
through :func:`repro_torch.serving.serve`.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.smr.base import SmrScheme
from ..kernels import ops
from ..kernels import ref as kref
from ..models.layers import apply_rope, rms_norm, rope_angles
from ..models.params import DTYPES, resolve_device
from ..models.registry import derive_draft
from ..models.transformer import _qkv, ffn_apply
from ..runtime.block_pool import BlockPool, PageNode
from ..runtime.prefix_cache import PrefixCache
from ..runtime.swap import SwapArena, SwapArenaFullError, SwapChecksumError
from .config import ServingConfig
from .decode_graph import DecodeGraph, captures
from .faults import build_fault_line
from .lru_index import BatchedLruEviction
from .paged_stack import stack_class
from .policies import as_admission_policy, as_scheduler_policy
from .sampling import as_sampling_policy
from .spans import SpanRecorder


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    priority: int = 0               # consumed by the 'priority' admission
    # named priority class (ServingConfig.priority_classes): resolves to
    # ``priority`` plus per-class TTFT/ITL SLOs at submit() time
    priority_class: Optional[str] = None
    # per-request deadline: timeout_s resolves at submit() (falling back
    # to ServingConfig.default_timeout_s); deadline is the absolute
    # perf_counter stamp — set once, kept across migration (a request
    # does not get a fresh budget by moving shards)
    timeout_s: Optional[float] = None
    deadline: Optional[float] = None
    # TTFT SLO deadline (priority-class ttft_slo_s): enforced by the sweep
    # only while no token has been emitted — once out_times is non-empty
    # the SLO is either met or already violated, never enforceable
    ttft_deadline: Optional[float] = None
    # terminal diagnostics (crash tracebacks, migration failures,
    # deadline expiry) — surfaced by RequestHandle.result()
    error: Optional[str] = None
    # named sampling policy (or instance): resolved to a SamplingPolicy by
    # _validate() on the caller thread.  None → greedy (bit-identical to
    # the pre-sampling engine).  The policy carries the per-request seed,
    # stop sequences and the logprobs flag (DESIGN.md §17)
    sampling: Optional[object] = None
    req_id: int = field(default_factory=itertools.count().__next__)
    out_tokens: List[int] = field(default_factory=list)
    # sampled-token log-probabilities under the FILTERED distribution, one
    # per out_tokens entry — recorded only when sampling.logprobs is set
    out_logprobs: List[float] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: threading.Event = field(default_factory=threading.Event)
    # "waiting" → "prefilling" → "active" → "done" | "cancelled" | "failed"
    # (engine-owned; "prefilling" = pages reserved, prompt chunks still
    # being ingested under the step budget).  A preempted request parks as
    # "swapped" — K/V pages spilled to the host arena, re-queued — and
    # goes back through "prefilling" when re-admitted (DESIGN.md §15)
    status: str = "waiting"
    # times this request was preempted into the host swap arena
    preemptions: int = 0
    # latency surface: submit() stamp + one perf_counter per emitted token,
    # so TTFT and inter-token latencies are measurable without polling
    t_submit: float = 0.0
    out_times: List[float] = field(default_factory=list)
    # first admission's stamp (pages reserved); None until then
    t_admit: Optional[float] = None
    # set on every generated token and on completion (stream wakeups)
    _progress: threading.Event = field(default_factory=threading.Event)
    # filled at submit time (client thread): prefix-cache hit
    _hit_pages: List[PageNode] = field(default_factory=list)
    _hit_tokens: int = 0
    # observed-only ITL SLO (priority class), counted in stats()
    _itl_slo_s: Optional[float] = None
    # replay-prompt cursor: out_tokens[:_folded] are already folded into
    # ``prompt`` by an earlier preemption/migration — folding ALL emitted
    # tokens again would duplicate them in the replay prompt
    _folded: int = 0
    # positions 0.._swap_tokens-1 of the replay prompt have their K/V in
    # the shard's swap arena
    _swap_tokens: int = 0
    # a live-migrated decoding sequence's pages, carried from the source
    # shard: (k, v, n) host copies (pages, L, page, Hkv, D) of replay-prompt
    # positions 0..n-1, taken by the source's steal_live and consumed by
    # the target's admission
    _carried: Optional[tuple] = None
    # ITL gap accounting (DESIGN.md §17): set by preemption/migration, the
    # next _emit() marks the incoming inter-token interval as a service
    # gap — excluded from RequestHandle.itl() and the ITL-SLO observation,
    # reported separately via gaps()/stats()
    _gap_pending: bool = False
    _gap_marks: List[int] = field(default_factory=list)
    # a stop sequence matched the emitted suffix: generation halts with
    # status "done" (the matched tokens are included in out_tokens)
    _stop_hit: bool = False

    def fold_emitted(self) -> None:
        """Fold tokens emitted since the last fold into the replay prompt.

        This IS the teacher-forcing mechanism every resume path relies on:
        folded tokens are re-ingested as PROMPT tokens by prefill (their
        K/V reproduced from the recorded ids, never re-sampled), so the
        emitted stream is force-fed on replay whatever the sampling policy
        — the engine does not depend on greedy determinism here.  Fresh
        positions after the fold re-enter the sampler with the same
        (seed, absolute_position) PRNG key the uninterrupted run would
        have used, which is the second half of the replay-exactness
        argument (DESIGN.md §17).  ``max_new_tokens`` shrinks by the same
        count so the request's total budget is unchanged.  Idempotent per
        token via the ``_folded`` cursor — a request preempted or migrated
        twice must not fold the first leg's tokens twice."""
        new = self.out_tokens[self._folded:]
        if new:
            self.prompt = list(self.prompt) + new
            self.max_new_tokens -= len(new)
            self._folded = len(self.out_tokens)

    def next_position(self) -> int:
        """Absolute position (in the request's original prompt + output
        stream) of the NEXT token to be sampled — invariant under
        fold_emitted(), the counter-PRNG's replay coordinate."""
        return len(self.prompt) + len(self.out_tokens) - self._folded


def verify_lanes(ctx, nd, occ, spec_k: int):
    """The speculative verify chunk's lane layout, host side: B rows of
    ``spec_k + 1`` lanes each, lane ``i * (spec_k + 1) + j`` holding row
    i's token j at absolute position ``ctx[i] - 1 + j``.  A lane is live
    when ``j <= nd[i]`` and row i is occupied; dead lanes get segment -1
    (their positions may lie past the row's page run: nothing may index
    with them).  ctx, nd, occ: (B,) host arrays.  Returns (lane_row (LV,),
    positions (LV,) int32, seg_ids (LV,) int32, seg_ctx (B,) int32: one
    past each row's last live position, 0 for unoccupied rows).  The
    engine's verify takes the first three; seg_ctx completes the packed
    kernel's operands at this layout (the reference's verify), which
    ``chip_smoke.py`` phase 4b and the layout tests hold and time."""
    lanes_per = spec_k + 1
    lv = len(ctx) * lanes_per
    lane_row = np.arange(lv) // lanes_per
    lane_j = np.arange(lv) % lanes_per
    positions = (np.asarray(ctx)[lane_row] - 1 + lane_j).astype(np.int32)
    live = (lane_j <= np.asarray(nd)[lane_row]) & np.asarray(occ)[lane_row]
    seg_ids = np.where(live, lane_row, -1).astype(np.int32)
    seg_ctx = np.where(occ, np.asarray(ctx) + np.asarray(nd), 0)
    return lane_row, positions, seg_ids, seg_ctx.astype(np.int32)


class _Seq:
    def __init__(self, req: Request, pages: List[PageNode], owned_from: int,
                 page_row: "np.ndarray"):
        self.req = req
        self.pages = pages              # full block run (shared prefix + owned)
        self.owned_from = owned_from    # pages[owned_from:] are owned
        self.tokens = list(req.prompt)
        self.new_tokens = 0
        # chunked-prefill cursor: prompt tokens whose K/V already sit in
        # pages (starts at the page-aligned prefix-cache hit; the scheduler
        # advances it one page-aligned chunk at a time until it reaches
        # len(prompt) and the first token is emitted)
        self.filled = req._hit_tokens
        # block-table row is fixed for the sequence's lifetime (pages are
        # allocated up front at admission) — precomputed once, reused every
        # decode step instead of re-walking the page list
        self.page_row = page_row


class _ShardEngine:
    """One shard: one pool, one prefix cache, one SMR domain, one thread."""

    def __init__(self, model, params, config: ServingConfig, *,
                 device=None, smr: Optional[SmrScheme] = None,
                 shard_id: int = 0, prefix_traversal=None):
        cfg = model.cfg
        make_stack = stack_class(cfg, config)     # refuses before building
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        if params.embed.device != self.device or \
                params.embed.dtype != self.dtype:
            raise ValueError(
                f"params live on {params.embed.device} as "
                f"{params.embed.dtype}, but the engine runs on "
                f"{self.device} in the config's {self.dtype}")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.config = config
        self.shard_id = shard_id
        self.page_size = config.page_size
        self.max_batch = config.max_batch
        self.max_pages = config.max_pages
        # SMR domain: per-shard fresh instance unless the session shares one
        self.smr = smr if smr is not None else config.build_scheme()
        self.pool = BlockPool(self.smr, config.num_pages,
                              pool_scheme=config.pool_scheme)
        self.prefix_cache = PrefixCache(
            self.smr, self.pool, config.page_size,
            max_entries=config.prefix_cache_entries,
            # prefix_traversal= lets the legacy shim pass a live
            # TraversalPolicy instance (config carries names only)
            traversal=(prefix_traversal if prefix_traversal is not None
                       else config.prefix_traversal),
            # the copied LRU index with its stamps entered in batches, so
            # its NM-tree stays shallow (serving/lru_index.py)
            eviction=(BatchedLruEviction() if config.eviction == "lru"
                      else config.eviction))
        self.admission = as_admission_policy(config.admission)
        self.scheduler = as_scheduler_policy(config.scheduler)
        # the kernels build here, on the constructing thread, never inside
        # a step (where the build would hold the step lock)
        ops.prepare(self.device)
        # the serving loop's spans (serving/spans.py): always-on totals,
        # a ring while a capture is open
        self.spans = SpanRecorder()
        self._capture = None
        # the pool and the decoder blocks over it; the K/V pair (None under
        # a latent pool) is read and written in place through these names
        self.stack = make_stack(cfg, params, config, self.spans,
                                self._to_dev)
        self.k_pages, self.v_pages = self.stack.k_pages, self.stack.v_pages
        # the decode call replayed as one CUDA graph where the stack's rows
        # can be captured and the shard runs on the card
        # (serving/decode_graph.py); captured at the first decode call
        self._decode_graph = DecodeGraph(
            self.stack, self._decode_rows, self._decode_operands(),
            self.device) if captures(self.stack, self.device) else None
        self._waiting = self.admission.new_queue()
        self._wlock = threading.Lock()
        # scheduler states: _prefilling (pages reserved, prompt chunks
        # pending) and _active (decoding); together they share max_batch
        self._prefilling: List[_Seq] = []
        self._active: List[_Seq] = []
        self._stop = threading.Event()
        self._run_started = threading.Event()
        self._run_done = threading.Event()
        # serializes step()/drain: stop() may not tear pages out from under
        # a decode iteration that already read the block tables
        self._step_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # speculative decoding: a sliced-parameter draft proposes spec_k
        # tokens per round; the target verifies them in ONE pass over a
        # lane chunk with fused on-device rejection sampling.  The draft
        # runs as a pure function of the recorded token stream (its cache is
        # rebuilt inside the propose call each round), so draft behavior —
        # and with it the accept pattern and the emitted stream — is
        # replay-exact by construction (DESIGN.md §17)
        self.spec_k = config.spec_k
        self.draft_cfg = None
        self.draft_params = None
        if self.spec_k > 0:
            draft_model, self.draft_params = derive_draft(
                model, params, config.spec_draft, config.spec_draft_layers)
            self.draft_cfg = draft_model.cfg
        # host swap tier (DESIGN.md §15): the arena exists whenever the
        # config budgets host bytes; PREEMPTION additionally requires the
        # eviction policy to opt in via its ``swaps`` marker (resolved from
        # the cache's bound policy so instances work, not just names).  A
        # bf16 page is held as its 16-bit pattern: the arena sizes its
        # buffers with numpy dtypes, and numpy has no bfloat16
        self.swap_arena: Optional[SwapArena] = None
        if config.swap_bytes > 0:
            # the arena's slot allocator negotiates the same scheme as the
            # BlockPool free list (lock-free by default, "locked" fallback)
            self.swap_arena = SwapArena(
                config.swap_bytes, n_layers=cfg.n_layers,
                page_size=config.page_size,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                dtype=("uint16" if self.dtype == torch.bfloat16
                       else cfg.dtype), scheme=config.pool_scheme)
        self.swap_enabled = self.swap_arena is not None and \
            getattr(self.prefix_cache.eviction, "swaps", False)
        self.steps = 0
        self.n_completed = 0
        self.n_cancelled = 0
        self.n_failed = 0
        # swap tier + SLO counters (stats())
        self.n_preemptions = 0          # sequences preempted to the arena
        self.n_resumed = 0              # swapped sequences re-admitted
        self.n_slo_cancelled = 0        # TTFT SLO expiries (subset of
        #                                 n_cancelled)
        self.n_itl_violations = 0       # observed inter-token SLO misses
        # prompt tokens run through a prefill chunk (no padding, no hits)
        self.prefill_tokens_computed = 0
        # occupied rows of every decode call, and their summed context
        # lengths (the keys the paged kernel reads a layer)
        self.decode_rows = 0
        self.decode_kv_tokens = 0
        # ITL gap accounting: intervals spanning a preemption park or a
        # migration stall, excluded from itl() and the SLO observation
        self.n_gap_intervals = 0
        self.gap_seconds = 0.0
        # speculative decoding counters (stats()): accept_rate =
        # draft_accepted / draft_proposed
        self.n_draft_proposed = 0
        self.n_draft_accepted = 0
        self.n_spec_rounds = 0          # verify chunks (one per round)
        # prefill efficiency counters (stats()): every fixed-shape chunk
        # call pays for C lanes — `prefill_tokens_wasted` counts the padded
        # lanes that bought nothing, and the packed pair shows how many
        # segments shared each packed chunk (the whole point of `packed`)
        self.prefill_chunks = 0
        self.prefill_tokens_wasted = 0
        self.packed_chunks = 0
        self.packed_segments = 0
        # packed chunks that carried decode riders: each runs the riders'
        # decode step too (one paged launch a layer)
        self.rider_chunks = 0
        # dedicated decode steps (one paged launch a layer each)
        self.decode_steps = 0
        # decode calls (steps, riders, warm-up) served by a graph replay
        self.decode_graph_replays = 0
        # fault tolerance (DESIGN.md §14): the shard's scheduled faults,
        # its loop heartbeat, and the recovery counters stats() exposes
        self.fault_line = build_fault_line(config.faults, shard_id)
        self.beat = 0               # bumped once per run()-loop iteration
        self.crashed = False        # engine-thread-owned (crash guard)
        self.degraded = False       # watchdog-owned
        self.error: Optional[str] = None
        self.heartbeat_misses = 0
        self.degraded_steps = 0
        self.n_migrated_in = 0
        self.n_migrated_out = 0

    # ---------------------------------------------------------- client API
    def _attach_hit(self, req: Request, pages: List[PageNode],
                    n_tok: int) -> None:
        # only reuse *strictly shorter than prompt* prefixes (need ≥1 token
        # to prefill so we have logits for the first generated token).
        # lookup() caps n_tok at the longest page-aligned prefix, so the
        # boundary case is exactly n_tok == len(prompt) with a page-aligned,
        # fully-cached prompt — drop is then 1 (the last page), and each
        # dropped page gives back exactly the one pin lookup took on it
        if n_tok >= len(req.prompt):
            drop = (n_tok - len(req.prompt)) // self.page_size + 1
            for p in pages[len(pages) - drop:]:
                self.pool.unpin(p)
            pages = pages[:len(pages) - drop]
            n_tok = len(pages) * self.page_size
        req._hit_pages, req._hit_tokens = pages, n_tok

    def _check_open(self):
        if self.crashed:
            head = self.error.strip().splitlines()[-1] if self.error else ""
            raise RuntimeError(f"shard {self.shard_id} crashed ({head}); "
                               f"no new submissions")
        if self._stop.is_set():
            raise RuntimeError("engine is stopped; no new submissions")

    def _stamp_deadline(self, req: Request) -> None:
        if req.priority_class is not None:
            # class wins over a hand-set priority: the class IS the
            # scheduling contract (raises ValueError on an unknown name,
            # still on the client thread)
            cls = self.config.priority_class(req.priority_class)
            req.priority = cls.priority
            if cls.ttft_slo_s is not None and req.ttft_deadline is None:
                req.ttft_deadline = req.t_submit + cls.ttft_slo_s
            req._itl_slo_s = cls.itl_slo_s
        t = req.timeout_s if req.timeout_s is not None \
            else self.config.default_timeout_s
        if t is not None and req.deadline is None:
            req.deadline = req.t_submit + t

    def _validate(self, req: Request) -> None:
        # resolve the sampling policy HERE, on the caller thread: an
        # unknown name raises at submit()/receive_migrated() time, never
        # inside the step loop (idempotent — instances pass through)
        req.sampling = as_sampling_policy(req.sampling)
        if not req.prompt:
            raise ValueError(f"request {req.req_id} has an empty prompt "
                             f"(need >= 1 token to prefill)")
        total = len(req.prompt) + req.max_new_tokens
        if total > self.config.max_seq_len:
            raise ValueError(
                f"request {req.req_id} needs {total} tokens but "
                f"max_seq_len={self.config.max_seq_len}; raise the config "
                f"limit or shorten the request")

    def submit(self, req: Request) -> Request:
        """Client-thread path: optimistic prefix lookup happens HERE,
        concurrently with the engine and janitor threads."""
        with self.spans.span("submit", req=req.req_id):
            self._check_open()
            self._validate(req)
            req.t_submit = time.perf_counter()
            self._stamp_deadline(req)
            with self.spans.span("prefix_cache.lookup"):
                pages, n_tok = self.prefix_cache.lookup(req.prompt)
            self._attach_hit(req, pages, n_tok)
            with self._wlock:
                # re-check under the queue lock: stop() sets the flag
                # BEFORE its drain takes this lock, so a push that wins the
                # lock after the drain must see the flag — no request can
                # strand in a dead queue with its hit pages pinned
                stopped = self._stop.is_set()
                if not stopped:
                    self.admission.push(self._waiting, req)
            if stopped:
                self._drop_hits([req])
            return req

    def _drop_hits(self, reqs: Sequence[Request]):
        for req in reqs:
            for pg in req._hit_pages:
                self.pool.unpin(pg)
            req._hit_pages = []
            req._hit_tokens = 0
        raise RuntimeError("engine is stopped; no new submissions")

    def submit_many(self, reqs: Sequence[Request]) -> Sequence[Request]:
        """Batched admission (DESIGN.md §4): ALL prompts' prefix lookups run
        under one SMR guard scope — one reservation lifecycle for the whole
        admission wave instead of one per request — and the waiting queue is
        extended under a single lock acquisition."""
        with self.spans.span("submit"):
            self._check_open()
            for req in reqs:
                self._validate(req)
            now = time.perf_counter()
            for req in reqs:
                req.t_submit = now
                self._stamp_deadline(req)
            with self.spans.span("prefix_cache.lookup"):
                hits = self.prefix_cache.lookup_many([r.prompt for r in reqs])
            for req, (pages, n_tok) in zip(reqs, hits):
                self._attach_hit(req, pages, n_tok)
            with self._wlock:
                # see submit(): drain-vs-push race
                stopped = self._stop.is_set()
                if not stopped:
                    for req in reqs:
                        self.admission.push(self._waiting, req)
            if stopped:
                self._drop_hits(reqs)
            return reqs

    def waiting_count(self) -> int:
        with self._wlock:
            return len(self._waiting)

    # ----------------------------------------------------- migration API
    # (watchdog-thread entry points; protocol in DESIGN.md §14 and the
    # serving/watchdog.py module docstring)
    def steal_waiting(self) -> List[Request]:
        """Drain a degraded shard's waiting queue.  Queue-lock only —
        safe whatever the (possibly wedged) engine thread is doing."""
        with self._wlock:
            return self.admission.drain(self._waiting)

    def steal_live(self, timeout: float) -> Optional[List["_Seq"]]:
        """Take ownership of the live (prefilling + active) sequences.
        Needs the step lock — a shard stalled INSIDE a step still owns
        its lists and its device buffers; returns ``None`` when the lock
        cannot be had within ``timeout`` (the watchdog backs off
        exponentially and eventually fails the handles out)."""
        if not self._step_lock.acquire(timeout=timeout):
            return None
        try:
            for seq in self._active:
                # a decoding sequence carries every written position's
                # pages (the partly filled last one too) to its target,
                # as a swap victim spills them: re-ingesting them by
                # prefill would round otherwise than the decode steps
                # that wrote them
                written = len(seq.tokens) - 1
                n_pages = -(-written // self.page_size)
                if n_pages:
                    k_np, v_np = self.stack.pages_to_host(
                        seq.page_row[:n_pages])
                    seq.req._carried = (k_np, v_np, written)
            seqs = self._prefilling + self._active
            self._prefilling = []
            self._active = []
            return seqs
        finally:
            self._step_lock.release()

    def receive_migrated(self, req: Request) -> Request:
        """Adopt a migrated request: pin THIS domain's prefix hit for the
        (replayed) prompt, record the handoff, and enqueue.  The caller
        retires the SOURCE domain's claim only after this returns — so
        between lookup-pin here and export there, both domains pin, and
        at no instant does neither.  ``t_submit``/``deadline`` are kept:
        migration does not grant a fresh time budget."""
        self._check_open()
        self._validate(req)
        pages, n_tok = self.prefix_cache.lookup(req.prompt)
        self._attach_hit(req, pages, n_tok)
        self.pool.import_claim(req._hit_pages)
        req.status = "waiting"
        with self._wlock:
            stopped = self._stop.is_set()  # see submit(): drain-vs-push race
            if not stopped:
                self.admission.push(self._waiting, req)
        if stopped:
            self._drop_hits([req])
        self.n_migrated_in += 1
        return req

    # ------------------------------------------------------------- device fns
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device.  On the card the copy
        goes through pinned memory and does not block: a copy from
        pageable memory ends in a stream sync, which would wait for the
        work already queued (a packed step's chunk, before its riders'
        operands).  The caching host allocator keeps the pinned block
        until the copy is done."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _logits(self, h):
        """Final norm + LM head on the rows that emit, h (N, d) → (N, V)."""
        return ops.add_rms_norm(h, None, self.params.final_norm)[1] @ \
            self.params.lm_head

    def _paged_prefill_packed(self, tokens, seg_ids, positions, page_rows,
                              seg_ctx, emit_lanes, wr_page, wr_slot):
        """Ingest ONE fixed-shape prefill chunk: the device function of
        every scheduler (a ``chunked`` or ``oneshot`` chunk is one
        segment), so chunk N resumes bit-identically from chunk N-1's
        boundary whether that boundary came from a cache hit or an earlier
        chunk.

        tokens: (C,) — several sequences' prompt slices laid end to end
        in one fixed-shape chunk (C = prefill_chunk_tokens); seg_ids (C,)
        says which segment each lane belongs to (-1 = padding) and
        positions (C,) its absolute position in its OWN sequence.
        page_rows (S, max_pages) carries one block-table row per segment
        (S = the power-of-2 segment bucket; unused rows have seg_ctx 0),
        seg_ctx (S,) each segment's context end AFTER this chunk.  K/V is
        written into the pages per layer BEFORE attention reads them, so
        lanes of the same segment see their earlier same-chunk neighbours
        through the pages.  wr_page / wr_slot (C,) int64: each lane's
        target; padding lanes carry page -1 and write nothing.

        emit_lanes: the lanes whose logits are returned — (S,) the lane
        holding each segment's LAST token (clamped into range; rows of
        non-emitting segments are ignored by the host), or a one-lane
        slice, or None for no logits (a chunk that finishes no prompt).
        Returns the (S, V) logits of those lanes, or None."""
        x = self.stack.lanes(self.params.embed[tokens], seg_ids, positions,
                             page_rows, seg_ctx, wr_page, wr_slot)
        # one lm_head row per SEGMENT (S rows), not per lane
        return None if emit_lanes is None else self._logits(x[emit_lanes])

    def _paged_decode_step(self, block_tables, ctx_lens, tokens, occ,
                           positions, wr_page, wr_slot):
        """One token for every batch row.  ctx_lens INCLUDE the new token;
        its K/V is written at position ``positions`` = ctx_lens-1 (B,)
        int64, at (wr_page, wr_slot) (B,) int64.  ``occ`` (B,) bool marks
        real sequences: padded rows carry page -1 and never write a page,
        reused or otherwise, and the kernel pins their attention output to
        zero, so padding needs no reserved scratch page.  Returns (B, V)
        logits.  A call the shard's decode graph takes replays it; any
        other runs :meth:`_decode_rows`."""
        args = (block_tables, ctx_lens, tokens, occ, positions, wr_page,
                wr_slot)
        graph = self._decode_graph
        if graph is None or not graph.takes(block_tables):
            return self._decode_rows(*args)
        self.decode_graph_replays += 1
        # the logits are the graph's static output, which the next replay
        # overwrites: every reader enqueues on this stream before then
        # (_sample's argmax and its copy to the host, the riders' cat)
        return graph(*args)

    def _decode_rows(self, block_tables, ctx_lens, tokens, occ, positions,
                     wr_page, wr_slot):
        """The decode call's device work, eagerly: embedding gather, the
        stack's rows, final norm and head."""
        return self._logits(self.stack.rows(
            self.params.embed[tokens], block_tables, ctx_lens, occ,
            positions, wr_page, wr_slot))

    def _decode_operands(self):
        """(shape, dtype) of each operand of a decode call, in order."""
        b = self.max_batch
        return [((b, self.max_pages), torch.int32), ((b,), torch.int32),
                ((b,), torch.int64), ((b,), torch.bool), ((b,), torch.int64),
                ((b,), torch.int64), ((b,), torch.int64)]

    @staticmethod
    def _operands(seqs, n: int):
        """Sampling operands of ``seqs`` padded to ``n`` rows (padding rows
        greedy): sampf (n, 2) float32 [temperature, top_p] and sampi (n, 2)
        int64 [top_k, seed], host arrays."""
        sampf = np.zeros((n, 2), np.float32)
        sampi = np.zeros((n, 2), np.int64)
        for i, seq in enumerate(seqs):
            sp = seq.req.sampling
            sampf[i] = (sp.temperature, sp.top_p)
            sampi[i] = (sp.top_k, sp.seed)
        return sampf, sampi

    def _sample(self, logits, sampf, sampi, spos):
        """Fused sampling of logits (N, V) with host operands (sampf,
        sampi as from :meth:`_operands`, spos (N,) the absolute position
        each row samples AT, the counter-PRNG replay coordinate) → host
        (tokens, logprobs).  The one device→host sync of a step."""
        with self.spans.span("sample.launch"):
            toks, lps = ops.sample_tokens(logits, sampf[:, 0], sampi[:, 0],
                                          sampf[:, 1], sampi[:, 1], spos)
        with self.spans.span("sample.wait"):
            return toks.cpu().numpy(), lps.cpu().numpy()

    def _draft_propose(self, tok_buf, ctx, sampf, sampi):
        """Draft model: propose spec_k tokens per batch row, as a PURE
        function of the recorded token stream.

        tok_buf (B, S) int64 — each row's full recorded stream (prompt +
        emitted tokens), zero-padded; S is the batch's longest stream
        rounded up to a page (rows are causal, so the padding past a row's
        stream never reaches it); ctx (B,) its length.  The draft has NO
        persistent KV cache: every round re-prefills the stream densely
        (fp32 attention in plain PyTorch, as the reference's einsum),
        reads the hidden state at ctx-1, then runs spec_k-1 incremental
        steps against the just-built cache.  That costs a re-prefill per
        round but buys the replay property outright: draft proposals
        depend only on (recorded stream, seed, position), never on which
        schedule of preemptions/migrations built a cache — so the accept
        pattern and the emitted stream are resume-exact by construction
        (DESIGN.md §17).

        sampf/sampi (host, as from :meth:`_operands`): the draft proposes
        through the SAME filter as the target (q and p supported on the
        same candidate set keeps the rejection-sampling correctness
        argument clean) and draws with keys (seed, ctx + j, STREAM_DRAFT).
        Greedy rows propose exact argmax, which makes spec-greedy ≡
        plain-greedy token for token.

        Returns (d_toks (B, spec_k) int64, q_dists (B, spec_k, V) float32)
        where slot j is the proposal for absolute position ctx + j."""
        dcfg = self.draft_cfg
        dp = self.draft_params
        kd = self.spec_k
        b, s = tok_buf.shape
        hkv, dh = dcfg.n_kv_heads, dcfg.head_dim
        g = dcfg.n_heads // hkv
        scale = 1.0 / (dh ** 0.5)
        n_l = dcfg.n_layers
        sk = s + kd                     # prefill keys + incremental writes
        dev = self.device
        bidx = torch.arange(b, device=dev)
        x = dp.embed[tok_buf]                                # (B, S, d)
        pos = torch.arange(s, device=dev)
        angles = rope_angles(pos[None, :].expand(b, s), dh, dcfg.rope_theta)
        causal = pos[None, :] <= pos[:, None]                # (S, S)
        k_cache = torch.zeros((n_l, b, sk, hkv, dh), dtype=torch.float32,
                              device=dev)
        v_cache = torch.zeros_like(k_cache)
        for i, blk in enumerate(dp.blocks):
            h = rms_norm(x, blk.ln1)
            q, k, v = _qkv(blk.attn, dcfg, h)
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
            k_cache[i, :, :s] = k.float()
            v_cache[i, :, :s] = v.float()
            qf = q.reshape(b, s, hkv, g, dh).float() * scale
            sc = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache[i, :, :s])
            sc = sc.masked_fill(~causal, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            out = torch.einsum("bkgqs,bskd->bqkgd", pr,
                               v_cache[i, :, :s]).to(x.dtype)
            x = x + out.reshape(b, s, -1) @ blk.attn.wo
            x = x + ffn_apply(blk.ffn, rms_norm(x, blk.ln2))
        # rows past their ctx are garbage but unread: only the hidden state
        # at ctx-1 leaves the prefill (clamped for empty padding rows)
        hidden = rms_norm(x[bidx, (ctx - 1).clamp(min=0)], dp.final_norm)
        greedy = torch.as_tensor(sampf[:, 0] <= 0.0, device=dev)
        seed = torch.as_tensor(sampi[:, 1], device=dev)
        d_toks, q_dists = [], []
        for j in range(kd):
            logits = hidden @ dp.lm_head                     # (B, V)
            qd = kref.filtered_dist_ref(logits, sampf[:, 0], sampi[:, 0],
                                        sampf[:, 1])
            tok, _ = kref.gumbel_pick_ref(qd, kref.sample_key_ref(
                seed, ctx + j, kref.STREAM_DRAFT, dev))
            tok = torch.where(greedy, torch.argmax(logits, dim=-1), tok)
            d_toks.append(tok)
            q_dists.append(qd)
            if j == kd - 1:
                break
            # incremental draft step: feed the proposal at position ctx+j
            pj = ctx + j                                     # (B,)
            xs = dp.embed[tok][:, None, :]
            ang = rope_angles(pj[:, None], dh, dcfg.rope_theta)
            kmask = torch.arange(sk, device=dev)[None, :] <= pj[:, None]
            for i, blk in enumerate(dp.blocks):
                h = rms_norm(xs, blk.ln1)
                q, k, v = _qkv(blk.attn, dcfg, h)
                q = apply_rope(q, ang)
                k = apply_rope(k, ang)
                k_cache[i, bidx, pj] = k[:, 0].float()
                v_cache[i, bidx, pj] = v[:, 0].float()
                qf = q[:, 0].reshape(b, hkv, g, dh).float() * scale
                sc = torch.einsum("bkgd,bskd->bkgs", qf, k_cache[i])
                sc = sc.masked_fill(~kmask[:, None, None, :], float("-inf"))
                pr = torch.softmax(sc, dim=-1)
                out = torch.einsum("bkgs,bskd->bkgd", pr,
                                   v_cache[i]).to(xs.dtype)
                xs = xs + out.reshape(b, 1, -1) @ blk.attn.wo
                xs = xs + ffn_apply(blk.ffn, rms_norm(xs, blk.ln2))
            hidden = rms_norm(xs[:, 0], dp.final_norm)
        return torch.stack(d_toks, dim=1), torch.stack(q_dists, dim=1)

    def _spec_verify(self, x_last, d_toks, ctx, nd, occ, rows, sampf, sampi,
                     q_dists):
        """Target verify: score every draft chain in ONE (1, LV, d) pass
        through the model and rejection-sample on device.

        Lane layout: LV = max_batch * (spec_k + 1) lanes; lane i*(k+1)+j
        holds row i's token j (j == 0 → x_last, the latest emitted token
        whose K/V is not yet written; j >= 1 → d_toks[i, j-1]) at absolute
        position ctx[i] - 1 + j.  Dead lanes (j > nd[i], or unoccupied
        rows) write nothing (page -1) and attend nothing; their positions
        may lie past the row's page run, so the write targets are taken on
        the host for the live lanes only (the reference gathers every
        lane's page index and relies on XLA clamping it).  In a sampled
        row's first round the j == 0 lane REWRITES the last prompt
        position, which the prefill chunk wrote (see
        :meth:`_finish_prefill`).

        Attention runs each lane as one row of the paged decode kernel:
        the row's block table, ctx = the lane's position + 1, and the
        decode step's split count, so a lane sums its keys in the order
        the decode step sums that position's (the reference attends the
        chunk as packed prefill; the packed and paged kernels round
        differently, and the first op whose bytes differed between a
        verify lane and the decode step was that attention).  The
        projections, norms and FFN are row-wise products: in bf16 at
        TinyLlama-1.1B's shapes on the H100 their bytes were the decode
        step's in every layer (``chip_smoke.py``'s ``lane_vs_decode``), so
        an accepted position's K/V is the plain decode path's there.  In
        fp32 cuBLAS picks another algorithm by row count (layer 0's FFN
        differed by 1.3e-6 at 40 rows against 8), so the claim is not
        made for fp32.

        The target's K/V for accepted positions lands in the pages as a
        side effect (lanes j = 0..nd at positions ctx-1..ctx+nd-1); the
        correction/bonus token's K/V is NOT written — the next round's
        x_last lane writes it, preserving the engine invariant that the
        latest token's K/V is written by the step that consumes it.

        x_last, ctx, nd, occ (B,) and rows (B, max_pages) are host arrays;
        d_toks / q_dists stay on the device from :meth:`_draft_propose`.
        Returns host (toks (B, k+1), n_emit (B,), lps (B, k+1)); n_emit is
        zeroed for unoccupied rows."""
        b = x_last.shape[0]
        lanes_per = self.spec_k + 1
        pgsz = self.page_size
        lane_row, positions, seg_ids, _ = verify_lanes(
            ctx, nd, occ, self.spec_k)
        live = seg_ids >= 0
        wr = np.flatnonzero(live)
        wr_page = np.full(live.shape, -1, np.int64)
        wr_page[wr] = rows[lane_row[wr], positions[wr] // pgsz]
        toks = torch.cat([self._to_dev(x_last)[:, None], d_toks], dim=1)
        x = self.stack.rows(
            self.params.embed[toks.reshape(-1)], self._to_dev(rows[lane_row]),
            self._to_dev(np.where(live, positions + 1, 0).astype(np.int32)),
            self._to_dev(live), self._to_dev(positions), self._to_dev(wr_page),
            self._to_dev((positions % pgsz).astype(np.int64)))
        logits = self._logits(x)                              # (LV, V)
        p_dists = kref.filtered_dist_ref(
            logits, sampf[lane_row, 0], sampi[lane_row, 0],
            sampf[lane_row, 1]).reshape(b, lanes_per, -1)
        with self.spans.span("sample.launch"):
            toks_o, n_emit, lps = ops.spec_verify_rows(
                p_dists, q_dists, d_toks, nd, sampi[:, 1], ctx)
            n_emit = torch.where(torch.as_tensor(occ, device=self.device),
                                 n_emit, torch.zeros_like(n_emit))
        with self.spans.span("sample.wait"):
            return (toks_o.cpu().numpy(), n_emit.cpu().numpy(),
                    lps.cpu().numpy())

    # ------------------------------------------------------------- engine
    def _fault_dispatch(self) -> None:
        """Chaos hook immediately before a device dispatch (the ``delay``
        kind: a slow device, not a dead thread)."""
        if self.fault_line is not None:
            self.fault_line.on_dispatch(self)

    def _sweep_deadlines(self) -> None:
        """Per-request deadlines, enforced through the EXISTING cancel
        path: waiting requests are purged and failed out immediately (a
        full decode batch must not hide an expired request until its
        admission turn), live ones get their ``cancelled`` event set and
        the step loop reaps them exactly like a client cancel."""
        now = time.perf_counter()
        with self._wlock:
            expired = self.admission.purge(
                self._waiting,
                lambda r: r.cancelled.is_set() or
                self._expiry_reason(r, now) is not None)
        for req in expired:
            if not req.cancelled.is_set():
                why = self._expiry_reason(req, now)
                if why.startswith("TTFT"):
                    self.n_slo_cancelled += 1
                req.error = f"{why} (waiting)"
                req.cancelled.set()
            self._fail_out(req, "cancelled")
        for seq in self._prefilling + self._active:
            req = seq.req
            why = self._expiry_reason(req, now)
            if why is not None and not req.cancelled.is_set():
                if why.startswith("TTFT"):
                    self.n_slo_cancelled += 1
                req.error = f"{why} ({req.status})"
                req.cancelled.set()

    def _expiry_reason(self, req: Request, now: float) -> Optional[str]:
        """Why this request should be cancelled now, or None.  The TTFT
        SLO only bites while NO token exists."""
        if req.deadline is not None and now > req.deadline:
            return f"deadline exceeded after {now - req.t_submit:.3f}s"
        if req.ttft_deadline is not None and not req.out_times \
                and now > req.ttft_deadline:
            return (f"TTFT SLO exceeded (class {req.priority_class!r}: "
                    f"no first token after {now - req.t_submit:.3f}s)")
        return None

    def _fail_out(self, req: Request, status: str) -> None:
        """Drop a request that will never run: give back its hit pins
        and any host arena slots its swapped K/V still occupies."""
        for pg in req._hit_pages:
            self.pool.unpin(pg)
        req._hit_pages = []
        req._hit_tokens = 0
        self._release_swap(req)
        req.status = status
        if status == "cancelled":
            self.n_cancelled += 1
        else:
            self.n_failed += 1
        req._progress.set()
        req.done.set()

    def _release_swap(self, req: Request) -> None:
        """Discard the request's swap manifest (terminal paths and
        migration-away — the tokens themselves are the durable copy)."""
        if self.swap_arena is not None:
            self.swap_arena.release(req.req_id)
        req._swap_tokens = 0

    def _admit(self):
        """Admission reserves pages and enqueues — it NEVER runs model work,
        so a 4k-token prompt cannot stall the decode batch here.  The prompt
        is ingested chunk-by-chunk by :meth:`_step_locked` under the
        scheduler policy's token budget.

        With the ``swap`` eviction policy, a queue head that outranks the
        lowest-priority active sequence may PREEMPT it — both for a batch
        slot and for pages — spilling the victim's K/V to the host arena
        (DESIGN.md §15)."""
        while True:
            if len(self._active) + len(self._prefilling) >= self.max_batch:
                # batch full: a higher-priority head may still claim a slot
                # by preempting the lowest-priority active sequence
                if not self._preempt_for_slot():
                    return
                continue
            with self._wlock:
                req = self.admission.pop(self._waiting)
            if req is None:
                return
            if req.cancelled.is_set():
                self._fail_out(req, "cancelled")
                continue
            if not self._admit_one(req):
                return

    def _admit_one(self, req: Request) -> bool:
        """Reserve this request's pages and enqueue it for prefill;
        False stops this step's admission wave (pool pressure)."""
        resume = req.status == "swapped"
        if resume and not req._hit_pages:
            # restore prefix-cache hits FIRST: the replay prompt may have
            # become (partly) cache-resident while the request was parked —
            # any hit page supersedes the arena copy of the same positions.
            # Skipped when a failed resume attempt already holds pins
            # (re-looking-up would double-pin).
            pages, n_tok = self.prefix_cache.lookup(req.prompt)
            self._attach_hit(req, pages, n_tok)
        total = len(req.prompt) + req.max_new_tokens
        n_pages_needed = -(-total // self.page_size)
        pages = list(req._hit_pages)
        owned_from = len(pages)
        for _ in range(n_pages_needed - len(pages)):
            pg = self.pool.try_alloc(req.req_id)
            if pg is None:
                break
            pages.append(pg)
        if len(pages) < n_pages_needed and self.swap_enabled:
            # eviction pressure cannot be met from finished sequences:
            # preempt strictly-lower-priority ACTIVE sequences, reclaim
            # their retired pages into our own context, retry once
            if self._preempt_for_pages(req, n_pages_needed - len(pages)):
                self.smr.help_reclaim()
                for _ in range(n_pages_needed - len(pages)):
                    pg = self.pool.try_alloc(req.req_id)
                    if pg is None:
                        break
                    pages.append(pg)
        if len(pages) < n_pages_needed:
            # pool pressure: shed the eviction policy's quota for one
            # event, help reclamation, requeue ahead of peers (a swapped
            # request keeps its hit pins and its arena manifest for the
            # next attempt)
            for pg in pages[owned_from:]:
                self.pool.release(pg)
            self.prefix_cache.pressure_evict()
            self.smr.help_reclaim()
            with self._wlock:
                self.admission.requeue(self._waiting, req)
            return False
        page_ids = np.zeros((self.max_pages,), np.int32)
        for j, pg in enumerate(pages):
            page_ids[j] = pg.page_id
        seq = _Seq(req, pages, owned_from, page_ids)
        if req.t_admit is None:
            req.t_admit = time.perf_counter()
            self.spans.record("request.queue", req.t_submit, req.t_admit,
                              req.req_id)
        if resume or req._carried is not None:
            if resume:
                self._restore_swapped(req, seq)
            else:
                self._restore_carried(req, seq)
            if seq.filled == len(req.prompt) - 1:
                # every position but the latest token's is back in its
                # pages: the next decode step (or spec round) writes that
                # one and samples exactly as the uninterrupted run's did,
                # so the sequence skips prefill (nothing emitted this leg)
                seq.filled = len(req.prompt)
                seq.new_tokens = 0
                req.status = "active"
                self._active.append(seq)
                return True
        req.status = "prefilling"
        self._prefilling.append(seq)
        return True

    # ------------------------------------------------- preemption (swap)
    def _lowest_victim(self, below: int) -> Optional[_Seq]:
        """Lowest-priority active sequence STRICTLY below ``below`` —
        ties broken youngest-first (largest req_id: the sequence that got
        the least service loses).  Prefilling sequences are never victims
        (nothing decoded yet; their admission is about to be re-litigated
        anyway) and neither are cancelled ones (the reaper owns those)."""
        best = None
        best_key = None
        for seq in self._active:
            req = seq.req
            if req.cancelled.is_set() or req.priority >= below:
                continue
            key = (req.priority, -req.req_id)
            if best is None or key < best_key:
                best, best_key = seq, key
        return best

    def _preempt_for_slot(self) -> bool:
        """Batch full: preempt the lowest-priority active sequence iff the
        waiting-queue head strictly outranks it."""
        if not self.swap_enabled:
            return False
        with self._wlock:
            head = self.admission.peek(self._waiting)
        if head is None or head.cancelled.is_set():
            return False
        victim = self._lowest_victim(head.priority)
        if victim is None:
            return False
        return self._preempt_seq(victim)

    def _preempt_for_pages(self, req: Request, shortfall: int) -> bool:
        """Preempt strictly-lower-priority active sequences until their
        OWNED pages cover ``shortfall`` (all-or-nothing per victim: a
        victim whose spill does not fit the arena stays resident)."""
        freed = 0
        any_preempted = False
        while freed < shortfall:
            victim = self._lowest_victim(req.priority)
            if victim is None:
                return any_preempted
            owned = len(victim.pages) - victim.owned_from
            if not self._preempt_seq(victim):
                return any_preempted     # arena full: stop preempting
            any_preempted = True
            freed += owned
        return True

    def _preempt_seq(self, seq: _Seq) -> bool:
        """Spill one active sequence to the host arena and park it.

        ORDER (the mirror of migration's import-before-export): the
        device→host copy completes — ``.cpu()`` blocks on the transfer —
        and the manifest is recorded BEFORE ``_release_seq`` retires the
        device pages through the SMR, so at no instant does neither tier
        hold the K/V bytes.  Every page holding a written position spills,
        the partly filled last one included (the reference spills only
        full pages and re-ingests the tail by prefill chunks: here the
        prefill and decode paths run different kernels, whose results
        differ in the last bits, so a re-ingested tail would not replay
        bit-exactly); on resume only the latest token's K/V is missing,
        and the next decode step writes it as it would have.  False
        (victim stays resident, nothing released) when the arena cannot
        take the spill."""
        req = seq.req
        # positions 0..t-2 are in pages (the latest token's K/V is written
        # by the NEXT step); spill every page they touch
        written = len(seq.tokens) - 1
        n_spill = -(-written // self.page_size)
        if n_spill > 0:
            with self.spans.span("swap.out"):
                k_np, v_np = self.stack.pages_to_host(
                    seq.page_row[:n_spill])
            try:
                # the arena counts whole pages; _swap_tokens the written
                # positions among them
                self.swap_arena.store(req.req_id, k_np, v_np,
                                      n_spill * self.page_size)
            except SwapArenaFullError:
                return False
        # bytes are safe in the arena (or recomputable): NOW retire the
        # device claim through the normal SMR paths
        self._active.remove(seq)
        self._release_seq(seq)
        req._hit_pages = []
        req._hit_tokens = 0
        req.fold_emitted()
        req._swap_tokens = written
        req.status = "swapped"
        req._gap_pending = True     # next emit closes a service-gap interval
        req.preemptions += 1
        self.n_preemptions += 1
        with self._wlock:
            self.admission.push(self._waiting, req)
        return True

    def _restore_swapped(self, req: Request, seq: _Seq) -> None:
        """Copy a resuming sequence's arena pages back into its freshly
        allocated device pages and set its prefill cursor past the
        restored positions.  Prefix-cache hits win: arena pages the hit
        already covers are discarded; the device writes complete (a device
        synchronise) BEFORE the slots are freed — the swap-in half of the
        copy-before-free contract.  A checksum failure falls back to
        recompute-from-tokens (the prompt is authoritative) instead of
        decoding from corrupt KV."""
        start = req._hit_tokens          # page-aligned (lookup guarantees)
        man = self.swap_arena.manifest(req.req_id) \
            if self.swap_arena is not None else None
        if man is not None and req._swap_tokens > start:
            from_page = start // self.page_size
            try:
                k_np, v_np = self.swap_arena.load(req.req_id, from_page)
            except SwapChecksumError:
                seq.filled = start       # recompute everything past the hit
            else:
                with self.spans.span("swap.in"):
                    self.stack.pages_from_host(
                        seq.page_row[from_page:from_page + k_np.shape[0]],
                        k_np, v_np)
                seq.filled = req._swap_tokens
        self._release_swap(req)
        self.n_resumed += 1

    def _restore_carried(self, req: Request, seq: _Seq) -> None:
        """Copy a migrated sequence's carried pages (``req._carried``)
        into its freshly allocated pages past this shard's prefix hit
        (hit pages win, as on a swap resume) and set its prefill cursor
        past the carried positions."""
        k_np, v_np, n_tok = req._carried
        req._carried = None
        start = req._hit_tokens          # page-aligned (lookup guarantees)
        if n_tok > start:
            first = start // self.page_size
            self.stack.pages_from_host(seq.page_row[first:k_np.shape[0]],
                                       k_np[first:], v_np[first:])
            seq.filled = n_tok

    def _emit(self, seq: _Seq, tok: int, lp: float = 0.0) -> None:
        """Append one generated token and wake streamers."""
        seq.tokens.append(tok)
        req = seq.req
        now = time.perf_counter()
        if req._gap_pending and req.out_times:
            # the incoming interval spans a migration stall: mark it as a
            # SERVICE GAP — excluded from itl() and the ITL-SLO observation
            # (the SLO observes decode cadence), reported separately via
            # RequestHandle.gaps() and stats().  The mark indexes the
            # timestamp that CLOSES the gap interval
            req._gap_marks.append(len(req.out_times))
            self.n_gap_intervals += 1
            self.gap_seconds += now - req.out_times[-1]
        elif req._itl_slo_s is not None and req.out_times \
                and now - req.out_times[-1] > req._itl_slo_s:
            # ITL SLO is OBSERVED, never enforced: the request keeps running
            self.n_itl_violations += 1
        req._gap_pending = False
        req.out_tokens.append(tok)
        req.out_times.append(now)
        if len(req.out_times) == 1:
            self.spans.record("request.prefill", req.t_admit, now,
                              req.req_id)
        if req.sampling is not None and req.sampling.logprobs:
            req.out_logprobs.append(float(lp))
        # host-side stop-sequence match against the emitted suffix (the
        # matched tokens stay in the output; generation halts with "done")
        if req.sampling is not None and req.sampling.stop:
            for s in req.sampling.stop:
                if len(req.out_tokens) >= len(s) and \
                        tuple(req.out_tokens[-len(s):]) == s:
                    req._stop_hit = True
                    break
        req._progress.set()

    def _advance_prefill(self, seq: _Seq, grant: int) -> None:
        """Ingest the next ``grant`` prompt tokens of one prefilling
        sequence, one fixed-size chunk call at a time (grants larger than
        the chunk — the ``oneshot`` policy's whole prompts — just loop).
        The final chunk's logits yield the first generated token (streamed
        immediately) and move the sequence to decoding."""
        req = seq.req
        n_prompt = len(req.prompt)
        chunk = self.config.prefill_chunk_tokens
        end = min(seq.filled + grant, n_prompt)
        logits = None
        while seq.filled < end:
            with self.spans.span("chunk"):
                # one segment; padding lanes have segment and page -1
                n_valid = min(chunk, end - seq.filled)
                buf = np.zeros((chunk,), np.int64)
                buf[:n_valid] = req.prompt[seq.filled:seq.filled + n_valid]
                pos = seq.filled + np.arange(chunk, dtype=np.int32)
                seg = np.where(np.arange(chunk) < n_valid, 0,
                               -1).astype(np.int32)
                wr_page = np.full((chunk,), -1, np.int64)
                wr_page[:n_valid] = seq.page_row[pos[:n_valid] //
                                                 self.page_size]
                emit = seq.filled + n_valid == n_prompt and \
                    self._prefill_emits(seq)
                self._fault_dispatch()
                self.stack.count_lanes(seg, pos)
                logits = self._paged_prefill_packed(
                    self._to_dev(buf), self._to_dev(seg), self._to_dev(pos),
                    self._to_dev(seq.page_row[None]),
                    self._to_dev(np.asarray([seq.filled + n_valid],
                                            np.int32)),
                    slice(n_valid - 1, n_valid) if emit else None,
                    self._to_dev(wr_page),
                    self._to_dev((pos % self.page_size).astype(np.int64)))
            seq.filled += n_valid
            self.prefill_chunks += 1
            self.prefill_tokens_wasted += chunk - n_valid
            self.prefill_tokens_computed += n_valid
        if seq.filled == n_prompt:
            # final chunk: its last-position logits ARE the first token,
            # sampled at absolute position len(prompt); intermediate chunks
            # never sync with the device.  Speculative mode discards it for
            # a sampled row (see _finish_prefill) and skips the draw
            if not self._prefill_emits(seq):
                self._finish_prefill(seq, 0)
                return
            sampf, sampi = self._operands([seq], 1)
            tok, lp = self._sample(logits, sampf, sampi,
                                   np.asarray([n_prompt]))
            self._finish_prefill(seq, int(tok[0]), float(lp[0]))

    def _prefill_emits(self, seq: _Seq) -> bool:
        """Whether the final prefill chunk's token is emitted: always in
        plain mode; in speculative mode for a greedy row only."""
        return not self.spec_k or seq.req.sampling.temperature <= 0.0

    def _finish_prefill(self, seq: _Seq, tok: int, lp: float = 0.0) -> None:
        """A sequence's prompt is fully in pages and its first token is in
        hand: stream it and move the sequence to decoding (or straight to
        done — a max_new_tokens=1 request must not overshoot to 2).

        In SPECULATIVE mode a sampled row's chunk token is DISCARDED and
        nothing is emitted here: every token — including the first — comes
        out of a spec round, so a freshly admitted request and a resumed
        one take the exact same emission path (the first fresh position is
        drawn via accept/residual streams either way, which is what keeps
        the accept pattern replay-exact; DESIGN.md §17).  The sequence just
        activates with ``new_tokens = 0``.  A greedy row emits the chunk's
        token, as plain greedy does (the reference discards it for every
        row): its first spec round then writes a fresh position, where
        drawing the first token in a verify lane would rewrite the last
        prompt position's K/V, which the prefill chunk wrote, in the
        decode kernel's rounding and move every later token off plain
        greedy's in bf16."""
        req = seq.req
        self._prefilling.remove(seq)
        if not self._prefill_emits(seq):
            seq.new_tokens = 0
            if req.cancelled.is_set():
                self._finish(seq, "cancelled")
            else:
                req.status = "active"
                self._active.append(seq)
            return
        with self.spans.span("emit"):
            self._emit(seq, tok, lp)
        seq.new_tokens = 1
        if seq.new_tokens >= req.max_new_tokens \
                or req.cancelled.is_set() or req._stop_hit:
            self._finish(seq, "cancelled" if req.cancelled.is_set()
                         else "done")
        else:
            req.status = "active"
            self._active.append(seq)

    def _advance_packed(self, plan, riders):
        """Execute a whole prefill plan as packed fixed-shape chunks (the
        ``packed`` scheduler): every granted sequence's slice goes into ONE
        ``(C,)`` chunk with sequence-indicator segment ids, so the chunk
        budget buys C tokens of aggregate progress per kernel call instead
        of per sequence.  With chunked-style grants (sum ≤ C, ≤ max_batch
        sequences) one chunk per step suffices; the loop still splits
        defensively if a plan ever overflows C lanes or max_batch
        segments.

        FUSED STEP: ``riders`` is the step's active decode batch.  It
        rides the FIRST chunk: the same step runs the chunk and the
        riders' decode step (:meth:`_decode_logits`: the decode step's
        products at max_batch rows, its paged attention with
        ``decode_splits``) and samples the finishing prompts and the
        riders in one call, so the step's decode tokens cost no step of
        their own.  The reference instead lays each rider into the chunk
        as a one-lane segment; the port's packed kernel and the chunk's
        products round otherwise than the decode step's, which made a
        bf16 stream depend on which steps it rode.  Returns the riders'
        (next tokens, logprobs) pair of (n_riders,) arrays, or None when
        the plan was empty (caller falls back to the dedicated decode
        batch).

        The segment axis is BUCKETED to the next power of two above the
        actual segment count (1/2/4/.../max_batch): attention cost scales
        with S·max_pages keys in the plain version, so a 1-segment chunk
        must not pay the max_batch-wide rectangle."""
        chunk = self.config.prefill_chunk_tokens
        n_segs = self.max_batch
        pgsz = self.page_size
        queue = [(seq, grant) for seq, grant in plan if grant > 0]
        rider_toks = None
        first = True
        while queue:
            with self.spans.span("chunk"):
                toks = np.zeros((chunk,), np.int64)
                segs = np.full((chunk,), -1, np.int32)
                poss = np.zeros((chunk,), np.int32)
                # per-lane write targets (padding lanes: page -1, no write)
                upd = np.full((chunk,), -1, np.int64)
                slot = np.zeros((chunk,), np.int64)
                rows = np.zeros((n_segs, self.max_pages), np.int32)
                ctxs = np.zeros((n_segs,), np.int32)
                emit = np.full((n_segs,), chunk, np.int32)  # not finishing
                # the absolute position each emitting segment samples AT
                # (the counter-PRNG coordinate)
                spos = np.zeros((n_segs,), np.int64)
                members = []
                lane = 0
                while queue and lane < chunk and len(members) < n_segs:
                    seq, grant = queue.pop(0)
                    take = min(grant, chunk - lane)
                    si = len(members)
                    pos = np.arange(seq.filled, seq.filled + take)
                    toks[lane:lane + take] = \
                        seq.req.prompt[seq.filled:seq.filled + take]
                    segs[lane:lane + take] = si
                    poss[lane:lane + take] = pos
                    upd[lane:lane + take] = seq.page_row[pos // pgsz]
                    slot[lane:lane + take] = pos % pgsz
                    rows[si] = seq.page_row
                    ctxs[si] = seq.filled + take
                    spos[si] = seq.filled + take
                    if seq.filled + take == len(seq.req.prompt):
                        emit[si] = lane + take - 1
                    members.append((seq, take))
                    lane += take
                    if take < grant:
                        # chunk overflow: the remainder LEADS the next
                        # chunk.  A mid-chunk split point need not be
                        # page-aligned — alignment only matters at STEP end
                        # (prefix-cache resume), and the full grant lands
                        # within this plan.
                        queue.insert(0, (seq, grant - take))
                self.prefill_chunks += 1
                self.packed_chunks += 1
                self.packed_segments += len(members)
                self.prefill_tokens_wasted += chunk - lane
                self.prefill_tokens_computed += lane
                self.stack.count_lanes(segs, poss)
                self._fault_dispatch()
                # power-of-2 segment bucket: pay for the segments actually
                # present, not max_batch (seg ids are compact, so a prefix
                # slice of the per-segment operands is sufficient)
                n_b = min(n_segs,
                          1 << max(0, len(members) - 1).bit_length())
                logits = self._paged_prefill_packed(
                    self._to_dev(toks), self._to_dev(segs),
                    self._to_dev(poss),
                    self._to_dev(rows[:n_b]), self._to_dev(ctxs[:n_b]),
                    self._to_dev(np.clip(emit[:n_b], 0, chunk - 1)
                                 .astype(np.int64)),
                    self._to_dev(upd), self._to_dev(slot))[:len(members)]
            seqs = [seq for seq, _ in members]
            spos = spos[:len(members)]
            n_riders = len(riders) if first else 0
            if n_riders:
                self.rider_chunks += 1
                r_logits, r_ctx = self._decode_logits(riders)
                logits = torch.cat([logits, r_logits[:n_riders]])
                seqs += list(riders)
                spos = np.concatenate([spos, r_ctx[:n_riders]])
            # only a chunk that emits tokens (some prompt completed, or
            # decode riders aboard) syncs with the device
            out_np = lps_np = None
            emitting = any(emit[si] < chunk and self._prefill_emits(seq)
                           for si, (seq, _) in enumerate(members))
            if emitting or n_riders:
                sampf, sampi = self._operands(seqs, len(seqs))
                out_np, lps_np = self._sample(logits, sampf, sampi, spos)
            for si, (seq, take) in enumerate(members):
                seq.filled += take
                if emit[si] < chunk:
                    if not self._prefill_emits(seq):   # discarded anyway
                        self._finish_prefill(seq, 0)
                    else:
                        self._finish_prefill(seq, int(out_np[si]),
                                             float(lps_np[si]))
            if n_riders:
                rider_toks = (out_np[len(members):], lps_np[len(members):])
            first = False
        return rider_toks

    def _decode_logits(self, batch_seqs):
        """The decode step's device work for ``batch_seqs`` (padded to
        max_batch rows): writes each row's latest token's K/V and returns
        (logits (max_batch, V), ctx (max_batch,) host: the absolute
        position each row samples AT — ctx already counts the incoming
        token, so the sampled one sits at index ctx)."""
        with self.spans.span("decode.launch"):
            b = self.max_batch
            bt = np.zeros((b, self.max_pages), np.int32)
            ctx = np.ones((b,), np.int32)
            toks = np.zeros((b,), np.int64)
            occ = np.zeros((b,), bool)
            for i, seq in enumerate(batch_seqs):
                bt[i, :] = seq.page_row
                ctx[i] = len(seq.tokens)
                toks[i] = seq.tokens[-1]
                occ[i] = True
            n = len(batch_seqs)
            pos = (ctx - 1).astype(np.int64)
            self.decode_rows += n
            self.decode_kv_tokens += int(ctx[:n].sum())
            wr_page = np.where(occ, bt[np.arange(b), pos // self.page_size],
                               -1).astype(np.int64)
            host = (bt, ctx, toks, occ, pos, wr_page, pos % self.page_size)
            if self._decode_graph is not None:
                dev = self._decode_graph.upload(host)
            else:
                dev = [self._to_dev(a) for a in host]
            return self._paged_decode_step(*dev), ctx

    def _decode_batch(self, batch_seqs):
        """The dedicated decode step for ``batch_seqs`` (padded to
        max_batch rows) → (next tokens, logprobs) as host arrays."""
        self._fault_dispatch()
        logits, ctx = self._decode_logits(batch_seqs)
        self.decode_steps += 1
        sampf, sampi = self._operands(batch_seqs, self.max_batch)
        return self._sample(logits, sampf, sampi, ctx)

    def _spec_round(self) -> None:
        """One speculative round for the whole active batch: the draft
        proposes up to spec_k tokens per row, the target verifies every
        chain in ONE pass over a lane chunk with fused on-device rejection
        sampling, and each row emits its accepted prefix plus the
        correction/bonus token — always ≥ 1 token per row per round (two
        dispatches, one sync).

        Per-row draft depth ``nd = min(spec_k, remaining - 1, capacity -
        ctx)``: the round never emits past ``max_new_tokens`` and never
        writes K/V past the page run.  Both bounds are INVARIANT under
        ``fold_emitted()`` (remaining = max_new - new_tokens and capacity
        - ctx are conserved by the fold), so a resumed request sees the
        same nd schedule — hence the same accept pattern and tokens — as
        the uninterrupted run (DESIGN.md §17)."""
        batch = list(self._active)
        b = self.max_batch
        kd = self.spec_k
        ctx = np.ones((b,), np.int64)
        nd = np.zeros((b,), np.int64)
        occ = np.zeros((b,), bool)
        rows = np.zeros((b, self.max_pages), np.int32)
        x_last = np.zeros((b,), np.int64)
        # the draft's token buffer: the longest stream rounded up to a page
        s = -(-max(len(seq.tokens) for seq in batch) // self.page_size) * \
            self.page_size
        tok_buf = np.zeros((b, s), np.int64)
        for i, seq in enumerate(batch):
            t = len(seq.tokens)
            tok_buf[i, :t] = seq.tokens
            ctx[i] = t
            remaining = seq.req.max_new_tokens - seq.new_tokens
            capacity = len(seq.pages) * self.page_size
            nd[i] = max(0, min(kd, remaining - 1, capacity - t))
            occ[i] = True
            rows[i] = seq.page_row
            x_last[i] = seq.tokens[-1]
        sampf, sampi = self._operands(batch, b)
        self._fault_dispatch()
        d_toks, q_dists = self._draft_propose(
            self._to_dev(tok_buf), self._to_dev(ctx), sampf, sampi)
        self._fault_dispatch()
        # d_toks/q_dists stay on device between the two dispatches — the
        # only host sync in the round is reading the verdict below
        toks_np, n_np, lps_np = self._spec_verify(
            x_last, d_toks, ctx, nd, occ, rows, sampf, sampi, q_dists)
        self.n_spec_rounds += 1
        done = []
        with self.spans.span("emit"):
            for i, seq in enumerate(batch):
                req = seq.req
                self.n_draft_proposed += int(nd[i])
                self.n_draft_accepted += int(n_np[i]) - 1
                for j in range(int(n_np[i])):
                    if seq.new_tokens >= req.max_new_tokens \
                            or req.cancelled.is_set() or req._stop_hit:
                        break
                    self._emit(seq, int(toks_np[i, j]), float(lps_np[i, j]))
                    seq.new_tokens += 1
                if seq.new_tokens >= req.max_new_tokens \
                        or req.cancelled.is_set() or req._stop_hit:
                    done.append(seq)
        for seq in done:
            self._active.remove(seq)
            self._finish(seq, "cancelled" if seq.req.cancelled.is_set()
                         else "done")

    def _release_seq(self, seq: _Seq) -> None:
        for pg in seq.pages[seq.owned_from:]:
            self.pool.release(pg)
        for pg in seq.pages[:seq.owned_from]:  # drop admission pins
            self.pool.unpin(pg)

    def _finish(self, seq: _Seq, status: str = "done"):
        with self.spans.span("finish"):
            if seq.req.done.is_set():
                # the watchdog already failed this handle out (unstealable
                # crash path: status/counters stamped, ``cancelled`` set so
                # we reap it here) — just give the pages back
                with self.spans.span("pool.release"):
                    self._release_seq(seq)
                return
            # cache this sequence's page-aligned prefix (cancelled
            # sequences are not worth caching — their generation was cut
            # short), then release ownership
            if status == "done":
                with self.spans.span("prefix_cache.insert"):
                    self.prefix_cache.insert(seq.tokens, seq.pages)
                self.n_completed += 1
            elif status == "cancelled":
                self.n_cancelled += 1
            else:
                self.n_failed += 1
            with self.spans.span("pool.release"):
                self._release_seq(seq)
            seq.req.status = status
            seq.req._progress.set()
            seq.req.done.set()

    def warm_swap(self) -> None:
        """Run the device↔host page movers once, so the FIRST preemption
        doesn't pay their first-use cost (allocator growth, copy set-up)
        inside a high-priority request's TTFT window.  Gathers page 0 and
        scatters the identical bytes straight back — safe on a live
        engine, serialised with steps by the step lock.  No-op unless the
        swap tier is enabled."""
        if not self.swap_enabled:
            return
        page = np.zeros((1,), np.int64)
        with self._step_lock, torch.inference_mode():
            k_np, v_np = self.stack.pages_to_host(page)
            self.stack.pages_from_host(page, k_np, v_np)

    def warm_packed(self) -> None:
        """Launch every packed-prefill segment bucket (1, 2, 4, ...,
        max_batch) once with an all-padding chunk: padding lanes write
        nothing and the logits are discarded, so this only pays first-use
        costs — safe on a live engine (serialised with steps by the step
        lock).  No-op under a non-packing scheduler.  Latency-sensitive
        deployments call this before opening the doors."""
        if not getattr(self.scheduler, "packs", False):
            return
        chunk = self.config.prefill_chunk_tokens
        zeros = self._to_dev(np.zeros((chunk,), np.int64))
        segs = self._to_dev(np.full((chunk,), -1, np.int32))
        poss = self._to_dev(np.zeros((chunk,), np.int32))
        no_page = self._to_dev(np.full((chunk,), -1, np.int64))
        with self._step_lock, torch.inference_mode():
            n_b = 1
            while True:
                self._paged_prefill_packed(
                    zeros, segs, poss,
                    self._to_dev(np.zeros((n_b, self.max_pages), np.int32)),
                    self._to_dev(np.zeros((n_b,), np.int32)),
                    self._to_dev(np.zeros((n_b,), np.int64)),
                    no_page, zeros)
                if n_b >= self.max_batch:
                    break
                n_b = min(self.max_batch, n_b * 2)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def warm_decode(self) -> None:
        """Capture the decode step's graph, where the shard replays one,
        with an all-padding batch: no row is occupied and no page written,
        so this only pays the capture, which the first real decode call
        would pay otherwise — safe on a live engine (step lock).  No-op
        where the decode step runs eagerly."""
        if self._decode_graph is None:
            return
        with self._step_lock, torch.inference_mode():
            self._decode_logits([])
            torch.cuda.synchronize(self.device)

    def warm_spec(self) -> None:
        """Run the speculative round's two dispatches (draft-propose +
        verify) once with an all-padding batch so the first real round
        doesn't pay their first-use cost inside a request's latency
        window.  ``occ`` is all-False: every verify lane is dead, writes
        nothing, and ``n_emit`` comes back zero — safe on a live engine
        (step lock).  No-op unless speculative decoding is enabled."""
        if not self.spec_k:
            return
        b = self.max_batch
        sampf = np.zeros((b, 2), np.float32)
        sampi = np.zeros((b, 2), np.int64)
        ctx = np.ones((b,), np.int64)
        zeros = np.zeros((b,), np.int64)
        with self._step_lock, torch.inference_mode():
            d_toks, q_dists = self._draft_propose(
                self._to_dev(np.zeros((b, self.page_size), np.int64)),
                self._to_dev(ctx), sampf, sampi)
            self._spec_verify(zeros, d_toks, ctx, zeros,
                              np.zeros((b,), bool),
                              np.zeros((b, self.max_pages), np.int32),
                              sampf, sampi, q_dists)

    def step(self) -> bool:
        """One engine iteration; returns False when idle.  An open
        :meth:`ServingSession.profile` capture starts and stops here,
        between steps."""
        with self._step_lock, torch.inference_mode():
            if self._capture is not None:
                self._capture = self._capture.service()
            if not self._active and not self._prefilling and \
                    not self.waiting_count():
                return False
            # the step span is named by the step's kind once it is known;
            # a step that finds no work leaves it unnamed (not recorded)
            with self.spans.span(None, step=self.steps) as sp:
                return self._step_locked(sp)

    def _step_locked(self, sp) -> bool:
        with self.spans.span("admit"):
            self._sweep_deadlines()
            self._admit()
        if not self._active and not self._prefilling:
            return False
        sp.name = "step.decode"
        # drop cancelled prefilling sequences before spending budget on
        # them — their reserved pages (and hit pins) go straight back
        for seq in [s for s in self._prefilling
                    if s.req.cancelled.is_set()]:
            self._prefilling.remove(seq)
            self._finish(seq, "cancelled")
        # prefill phase: at most prefill_chunk_tokens of prompt ingestion,
        # divided by the scheduler policy — the ITL bound for everyone
        # already decoding is one chunk, never one prompt
        decoded = None
        batch_seqs = []
        if self._prefilling:
            plan = self.scheduler.plan(
                list(self._prefilling), self.config.prefill_chunk_tokens,
                self.page_size)
            if any(grant > 0 for _, grant in plan):
                sp.name = "step.chunk"
            if getattr(self.scheduler, "packs", False):
                # packed path: the WHOLE plan rides one fixed-shape chunk,
                # and the step's decode batch rides it too (fused step) —
                # sequences activated DURING this call decode next step.
                # Under SPECULATIVE decoding the active set never rides:
                # every emission must come from the spec round's streams
                # (accept/residual), not a schedule-dependent mix with
                # plain TARGET draws (DESIGN.md §17)
                batch_seqs = [] if self.spec_k else list(self._active)
                decoded = self._advance_packed(plan, batch_seqs)
            else:
                for seq, grant in plan:
                    if grant > 0:
                        self._advance_prefill(seq, grant)
        # decode phase: one token for every decoding sequence.  Rows beyond
        # the active set are padding — masked out of attention and never
        # written.  When the fused packed chunk already produced this
        # step's decode tokens, consume those instead of a second call.
        if decoded is None and self._active:
            if self.spec_k:
                # speculative mode replaces the dedicated decode step
                # entirely: one draft-propose + one verify per round
                if sp.name != "step.chunk":
                    sp.name = "step.spec"
                self._spec_round()
            else:
                batch_seqs = list(self._active)
                decoded = self._decode_batch(batch_seqs)
        if decoded is not None:
            next_toks, next_lps = decoded
            done = []
            with self.spans.span("emit"):
                for i, seq in enumerate(batch_seqs):
                    self._emit(seq, int(next_toks[i]), float(next_lps[i]))
                    seq.new_tokens += 1
                    if seq.new_tokens >= seq.req.max_new_tokens \
                            or seq.req.cancelled.is_set() \
                            or seq.req._stop_hit:
                        done.append(seq)
            for seq in done:
                self._active.remove(seq)
                self._finish(seq, "cancelled" if seq.req.cancelled.is_set()
                             else "done")
        self.steps += 1
        if self.degraded:
            # the watchdog flagged us stalled but the loop is advancing:
            # counted so recovery windows are visible in stats()
            self.degraded_steps += 1
        return True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Spawn the shard's own engine thread (session mode)."""
        if self._thread is not None:
            raise RuntimeError(f"shard {self.shard_id} already started")
        self._thread = threading.Thread(
            target=self.run, name=f"shard-{self.shard_id}-engine",
            daemon=True)
        self._thread.start()

    def run(self, poll_s: Optional[float] = None):
        """Engine loop (the shard thread, or a caller-owned thread).

        The current CUDA device and inference mode are thread-local, so the
        loop's thread selects the engine's device here (and ``step`` enters
        inference mode).  Every iteration bumps ``beat`` — the heartbeat
        the session watchdog reads — and runs the shard's fault line
        OUTSIDE the step lock (an injected stall models a descheduled
        thread *between* steps, so the watchdog can still steal the live
        sequences).  ANY escape, injected or real, hits the crash guard:
        every request fails out with the traceback instead of hanging its
        client (DESIGN.md §14)."""
        sleep_s = self.config.poll_s if poll_s is None else poll_s
        self._run_started.set()
        if self.fault_line is not None:
            self.fault_line.on_start(self)
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                self.beat += 1      # single-writer; watchdog only reads
                if self.fault_line is not None:
                    self.fault_line.before_step(self)
                if not self.step():
                    with self.spans.span("engine.idle"):
                        time.sleep(sleep_s)
        except BaseException as exc:  # noqa: BLE001 — the crash guard
            self._crash(exc)
        finally:
            self._run_done.set()

    def _crash(self, exc: BaseException) -> None:
        """The engine loop died: fail EVERY request out — waiting,
        prefilling and active — with the traceback surfaced through
        ``RequestHandle.result()``, release every page, and leave the
        pool provably clean.  No client ever hangs on a crashed shard;
        the watchdog sees ``crashed`` and routes around it (a crashed
        shard never recovers)."""
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        self.error = tb
        self.crashed = True
        # the stop flag goes up BEFORE the drain: submit()'s under-lock
        # re-check must see it, so no late submission strands hit pins
        self._stop.set()
        if self.fault_line is not None:
            self.fault_line.release(self)
        self._drain(error=tb)
        free = self.pool.free_count()
        assert free == self.config.num_pages, \
            (f"shard {self.shard_id} crash drain leaked pages: "
             f"{free}/{self.config.num_pages} free")

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the engine and (by default) drain it clean: join the engine
        thread, fail out waiting + prefilling + active sequences
        (releasing/unpinning their pages), purge the prefix cache, and flush
        reclamation — after which ``pool.stats()`` shows every page back on
        the free list (zero leaks)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        elif self._run_started.is_set():
            # the caller owns the run() thread — wait for the loop to
            # acknowledge the stop before tearing state down
            self._run_done.wait(timeout)
        if self.fault_line is not None:
            # after the join: anything a fault still holds (reader guard,
            # exhaustion pages) comes back before the drain accounts pages
            self.fault_line.release(self)
        cap, self._capture = self._capture, None
        if cap is not None:
            cap.fail(RuntimeError("the engine stopped during profile()"))
        if drain:
            self._drain()

    def _drain(self, error: Optional[str] = None) -> None:
        with self._step_lock:
            with self._wlock:
                leftover = self.admission.drain(self._waiting)
            for req in leftover:
                if error and req.error is None:
                    req.error = error
                self._fail_out(req, "cancelled" if req.cancelled.is_set()
                               else "failed")
            for seq in self._prefilling + self._active:
                if error and seq.req.error is None:
                    seq.req.error = error
                self._finish(seq, "failed")
            self._prefilling.clear()
            self._active.clear()
            self.prefix_cache.clear()
            self.smr.flush()

    def open_capture(self, cap) -> None:
        """Hand a :class:`~.spans.Capture` to the engine thread, which
        starts it at its next step."""
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError(f"shard {self.shard_id}'s engine thread is "
                               f"not running; profile() needs it")
        with self._step_lock:
            if self._capture is not None:
                raise RuntimeError("a profile() capture is already open")
            self._capture = cap

    def stats(self):
        spans = self.spans.totals()
        return {
            "shard": self.shard_id,
            "pool": self.pool.stats(),
            "prefix_cache": self.prefix_cache.stats(),
            "smr": self.smr.stats(),
            "steps": self.steps,
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "waiting": self.waiting_count(),
            "completed": self.n_completed,
            "cancelled": self.n_cancelled,
            "failed": self.n_failed,
            "preemptions": self.n_preemptions,
            "resumed": self.n_resumed,
            "slo_cancelled": self.n_slo_cancelled,
            "itl_slo_violations": self.n_itl_violations,
            "gap_intervals": self.n_gap_intervals,
            "gap_seconds": self.gap_seconds,
            "draft_proposed": self.n_draft_proposed,
            "draft_accepted": self.n_draft_accepted,
            "accept_rate": (self.n_draft_accepted / self.n_draft_proposed
                            if self.n_draft_proposed else 0.0),
            "spec_rounds": self.n_spec_rounds,
            "swap": (self.swap_arena.stats()
                     if self.swap_arena is not None else None),
            # host seconds moving pages device→host (gather + copy) and
            # host→device (copy + scatter + sync)
            "swap_out_s": spans.get("swap.out", (0, 0.0))[1],
            "swap_in_s": spans.get("swap.in", (0, 0.0))[1],
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_wasted": self.prefill_tokens_wasted,
            "packed_chunks": self.packed_chunks,
            "packed_segments": self.packed_segments,
            "rider_chunks": self.rider_chunks,
            "decode_steps": self.decode_steps,
            "decode_graph_replays": self.decode_graph_replays,
            "packed_segments_per_chunk": (
                self.packed_segments / self.packed_chunks
                if self.packed_chunks else 0.0),
            "beat": self.beat,
            "degraded": self.degraded,
            "crashed": self.crashed,
            "heartbeat_misses": self.heartbeat_misses,
            "degraded_steps": self.degraded_steps,
            "migrated_in": self.n_migrated_in,
            "migrated_out": self.n_migrated_out,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "decode_rows": self.decode_rows,
            "decode_kv_tokens": self.decode_kv_tokens,
            **self.stack.stats(),
            # batches of recency stamps the LRU index took, and their
            # stamps (0 under the other eviction policies)
            "lru_flushes": getattr(self.prefix_cache.eviction,
                                   "n_flushes", 0),
            "lru_flushed_stamps": getattr(self.prefix_cache.eviction,
                                          "n_flushed_stamps", 0),
            # {span name: (count, seconds)} (serving/spans.py)
            "spans": spans,
        }


class PagedServingEngine(_ShardEngine):
    """One-release compatibility shim: the pre-session construction surface.

    ``PagedServingEngine(model, params, smr=..., num_pages=..., ...)`` maps
    the old kwargs onto a :class:`ServingConfig` (with a
    ``DeprecationWarning``) and behaves as a single shard on ``device``
    (``None`` = the card, as :func:`repro_torch.serving.serve`).  New code
    builds a config and calls :func:`repro_torch.serving.serve`.
    """

    def __init__(self, model, params, *, smr="IBR",
                 num_pages: int = 256, page_size: int = 8,
                 max_batch: int = 4, max_seq_len: int = 256,
                 prefix_cache_entries: int = 128,
                 prefix_optimistic: Optional[bool] = None,
                 prefix_traversal=None,
                 config: Optional[ServingConfig] = None, device=None):
        if config is not None:
            super().__init__(model, params, config, device=device)
            return
        warnings.warn(
            "PagedServingEngine(...) kwargs are deprecated; build a "
            "repro_torch.serving.ServingConfig and open a session with "
            "repro_torch.serving.serve(model, params, config)",
            DeprecationWarning, stacklevel=2)
        if prefix_optimistic is not None:
            # thin shim for the pre-facade flag (one release)
            if prefix_traversal is not None:
                raise TypeError("PagedServingEngine: pass either "
                                "prefix_traversal= or the deprecated "
                                "prefix_optimistic= flag, not both")
            warnings.warn("PagedServingEngine(prefix_optimistic=...) is "
                          "deprecated; pass prefix_traversal='hm' for the "
                          "Harris-Michael prefix-cache buckets",
                          DeprecationWarning, stacklevel=2)
            prefix_traversal = None if prefix_optimistic else "hm"
        # an already-constructed scheme instance (shared with other
        # subsystems) bypasses the config's name-based construction
        shared = smr if isinstance(smr, SmrScheme) else None
        is_name = isinstance(prefix_traversal, str) or \
            prefix_traversal is None
        cfg = ServingConfig(
            smr=smr if isinstance(smr, str) else smr.name,
            num_pages=num_pages, page_size=page_size, max_batch=max_batch,
            max_seq_len=max_seq_len,
            prefix_cache_entries=prefix_cache_entries,
            prefix_traversal=prefix_traversal if is_name else None)
        super().__init__(model, params, cfg, device=device, smr=shared,
                         prefix_traversal=None if is_name
                         else prefix_traversal)
