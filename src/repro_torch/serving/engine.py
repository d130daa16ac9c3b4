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

What differs from the reference, all on the device side (the host logic is
the reference's):

* The KV pool is a pair of ``(L, num_pages, page, Hkv, D)`` tensors on the
  engine's device, updated IN PLACE (the reference donates its buffers to
  ``jit``).  The device functions are plain methods; PyTorch runs eagerly.
* Masked writes: only valid lanes / occupied rows are written
  (``index_put_`` on the selected positions).  A padding lane or an
  unoccupied row never writes a page, shared or recycled (the reference
  scatters them out of bounds with ``mode="drop"``).
* Every prefill attends through ``ops.packed_prefill_attention``: the
  ``chunked`` scheduler's single-sequence chunk is a packed chunk with one
  segment, so the default scheduler launches the kernel too.  The packed
  scheduler always takes the (segments x max_pages) rectangle with its
  power-of-two segment bucket; the reference's kernel-less ragged layout
  (``_paged_step_packed_flat``) is not ported.
* Not ported yet, and refused by ``ServingConfig`` / ``_validate``:
  speculative decoding, the host swap tier, and sampling with
  temperature > 0.
* Kernels are built when the shard is constructed (``ops.prepare``), never
  inside a step, where a first build would hold the step lock and read as
  a stall to the watchdog.

One :class:`_ShardEngine` is one SMR domain: in a :class:`ShardedEngine`
session each shard owns its own pool + prefix cache + (by default) its own
scheme instance, so a stalled thread pins O(K) pages *of one shard* and the
others keep reclaiming — the paper's robustness property applied as an
architecture decision (DESIGN.md §11).

Dense-family models only (engine v1).
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.smr.base import SmrScheme
from ..kernels import ops
from ..models.layers import apply_rope, rms_norm, rope_angles
from ..models.params import DTYPES, resolve_device
from ..models.transformer import _qkv, ffn_apply
from ..runtime.block_pool import BlockPool, PageNode
from ..runtime.prefix_cache import PrefixCache
from .config import ServingConfig
from .faults import build_fault_line
from .policies import as_admission_policy, as_scheduler_policy
from .sampling import as_sampling_policy


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
    # _validate() on the caller thread.  None → greedy.  The policy carries
    # the per-request seed, stop sequences and the logprobs flag
    # (DESIGN.md §17); the torch port serves greedy policies only
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
    # being ingested under the step budget)
    status: str = "waiting"
    # times this request was preempted into a host swap arena (always 0:
    # the swap tier is not ported yet)
    preemptions: int = 0
    # latency surface: submit() stamp + one perf_counter per emitted token,
    # so TTFT and inter-token latencies are measurable without polling
    t_submit: float = 0.0
    out_times: List[float] = field(default_factory=list)
    # set on every generated token and on completion (stream wakeups)
    _progress: threading.Event = field(default_factory=threading.Event)
    # filled at submit time (client thread): prefix-cache hit
    _hit_pages: List[PageNode] = field(default_factory=list)
    _hit_tokens: int = 0
    # observed-only ITL SLO (priority class), counted in stats()
    _itl_slo_s: Optional[float] = None
    # replay-prompt cursor: out_tokens[:_folded] are already folded into
    # ``prompt`` by an earlier migration — folding ALL emitted tokens
    # again would duplicate them in the replay prompt
    _folded: int = 0
    # ITL gap accounting (DESIGN.md §17): set by migration, the next
    # _emit() marks the incoming inter-token interval as a service gap —
    # excluded from RequestHandle.itl() and the ITL-SLO observation,
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
        emitted stream is force-fed on replay.  ``max_new_tokens`` shrinks
        by the same count so the request's total budget is unchanged.
        Idempotent per token via the ``_folded`` cursor — a request
        migrated twice must not fold the first leg's tokens twice."""
        new = self.out_tokens[self._folded:]
        if new:
            self.prompt = list(self.prompt) + new
            self.max_new_tokens -= len(new)
            self._folded = len(self.out_tokens)

    def next_position(self) -> int:
        """Absolute position (in the request's original prompt + output
        stream) of the NEXT token to be sampled — invariant under
        fold_emitted()."""
        return len(self.prompt) + len(self.out_tokens) - self._folded


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
                 shard_id: int = 0):
        cfg = model.cfg
        if cfg.family != "dense":
            raise ValueError(f"engine v1 serves dense models, got family "
                             f"{cfg.family!r}")
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
            traversal=config.prefix_traversal, eviction=config.eviction)
        self.admission = as_admission_policy(config.admission)
        self.scheduler = as_scheduler_policy(config.scheduler)
        # the kernels build here, on the constructing thread, never inside
        # a step (where the build would hold the step lock)
        ops.prepare(self.device)
        L = cfg.n_layers
        kv = (L, config.num_pages, config.page_size, cfg.n_kv_heads,
              cfg.head_dim)
        # the paged KV pool, written in place by every device function
        self.k_pages = torch.zeros(kv, dtype=self.dtype, device=self.device)
        self.v_pages = torch.zeros(kv, dtype=self.dtype, device=self.device)
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
        self.steps = 0
        self.n_completed = 0
        self.n_cancelled = 0
        self.n_failed = 0
        # SLO counters (stats())
        self.n_slo_cancelled = 0        # TTFT SLO expiries (subset of
        #                                 n_cancelled)
        self.n_itl_violations = 0       # observed inter-token SLO misses
        # ITL gap accounting: intervals spanning a migration stall,
        # excluded from itl() and the SLO observation
        self.n_gap_intervals = 0
        self.gap_seconds = 0.0
        # prefill efficiency counters (stats()): every fixed-shape chunk
        # call pays for C lanes — `prefill_tokens_wasted` counts the padded
        # lanes that bought nothing, and the packed pair shows how many
        # segments shared each packed chunk (the whole point of `packed`)
        self.prefill_chunks = 0
        self.prefill_tokens_wasted = 0
        self.packed_chunks = 0
        self.packed_segments = 0
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
        if req.sampling.temperature > 0.0:
            raise NotImplementedError(
                f"request {req.req_id}: sampling policy "
                f"{req.sampling.name!r} has temperature "
                f"{req.sampling.temperature} > 0, which the torch port does "
                f"not serve yet (ROADMAP A.5: JAX's threefry bits); use "
                f"greedy sampling")
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
        self._check_open()
        self._validate(req)
        req.t_submit = time.perf_counter()
        self._stamp_deadline(req)
        pages, n_tok = self.prefix_cache.lookup(req.prompt)
        self._attach_hit(req, pages, n_tok)
        with self._wlock:
            # re-check under the queue lock: stop() sets the flag BEFORE its
            # drain takes this lock, so a push that wins the lock after the
            # drain must see the flag — no request can strand in a dead
            # queue with its hit pages pinned
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
        self._check_open()
        for req in reqs:
            self._validate(req)
        now = time.perf_counter()
        for req in reqs:
            req.t_submit = now
            self._stamp_deadline(req)
        hits = self.prefix_cache.lookup_many([r.prompt for r in reqs])
        for req, (pages, n_tok) in zip(reqs, hits):
            self._attach_hit(req, pages, n_tok)
        with self._wlock:
            stopped = self._stop.is_set()  # see submit(): drain-vs-push race
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
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _layers(self, x, angles, write, attend):
        """Run every decoder block over x (B, S, d).  ``write(i, k, v)``
        stores the layer's new K/V into the pool (valid lanes only) and
        ``attend(i, q)`` returns the (B, S, H, D) attention output over the
        pool — the only two places the device functions differ."""
        cfg = self.cfg
        b, s, _ = x.shape
        for i, blk in enumerate(self.params.blocks):
            h = rms_norm(x, blk.ln1)
            q, k, v = _qkv(blk.attn, cfg, h)
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
            write(i, k, v)
            out = attend(i, q)
            x = x + out.reshape(b, s, -1) @ blk.attn.wo
            x = x + ffn_apply(blk.ffn, rms_norm(x, blk.ln2))
        return x

    def _logits(self, h):
        """Final norm + LM head on the rows that emit, h (N, d) → (N, V)."""
        return rms_norm(h, self.params.final_norm) @ self.params.lm_head

    def _paged_prefill(self, tokens, page_row, start: int, n_valid: int,
                       emit: bool):
        """Ingest ONE fixed-size prefill chunk of one sequence.

        tokens: (C,) — prompt[start : start+n_valid] zero-padded to the
        configured chunk size C; page_row: (max_pages,) the sequence's
        block run; start: tokens already in pages (page-aligned: a
        prefix-cache hit or the previous chunk's boundary); n_valid ≤ C.

        Only the chunk's C lanes run through the model; attention reads the
        earlier prefix K/V back from the PAGES through the packed-prefill
        kernel with one segment (seg_ids 0 on valid lanes, -1 on padding,
        positions start + arange(C), seg_ctx [start + n_valid]), exactly
        like a packed chunk — so chunk N resumes bit-identically from chunk
        N-1's boundary whether that boundary came from a cache hit or an
        earlier chunk.  Only the n_valid lanes write K/V.

        Returns the (1, V) logits of the last valid lane when ``emit``
        (the final chunk), else None."""
        cfg = self.cfg
        c = tokens.shape[0]
        pos = start + np.arange(c, dtype=np.int32)
        seg = np.where(np.arange(c) < n_valid, 0, -1).astype(np.int32)
        wr_pos = pos[:n_valid]
        wr_page = self._to_dev(page_row[wr_pos // self.page_size]
                               .astype(np.int64))
        wr_slot = self._to_dev((wr_pos % self.page_size).astype(np.int64))
        positions = self._to_dev(pos)
        seg_ids = self._to_dev(seg)
        page_rows = self._to_dev(page_row[None])
        seg_ctx = self._to_dev(np.asarray([start + n_valid], np.int32))
        x = self.params.embed[self._to_dev(tokens.astype(np.int64))][None]
        angles = rope_angles(positions[None], cfg.head_dim, cfg.rope_theta)

        def write(i, k, v):
            self.k_pages[i, wr_page, wr_slot] = k[0, :n_valid]
            self.v_pages[i, wr_page, wr_slot] = v[0, :n_valid]

        def attend(i, q):
            return ops.packed_prefill_attention(
                q[0], self.k_pages[i], self.v_pages[i], page_rows, seg_ids,
                positions, seg_ctx)

        x = self._layers(x, angles, write, attend)
        return self._logits(x[:, n_valid - 1]) if emit else None

    def _paged_prefill_packed(self, tokens, seg_ids, positions, page_rows,
                              seg_ctx, emit_lanes, wr_lanes, wr_page,
                              wr_slot):
        """Ingest ONE packed multi-segment chunk (the ``packed`` scheduler).

        tokens: (L,) — several sequences' prompt slices laid end to end
        in one fixed-shape chunk (L = prefill_chunk_tokens + max_batch:
        the C-token prefill budget plus one lane per possible decode
        rider); seg_ids (L,) says which segment each lane belongs to
        (-1 = padding) and positions (L,) its absolute position in its OWN
        sequence.  page_rows (S, max_pages) carries one block-table row per
        segment (S = the power-of-2 segment bucket; unused rows have
        seg_ctx 0), seg_ctx (S,) each segment's context end AFTER this
        chunk.  K/V is written into the pages per layer BEFORE attention
        reads them, so lanes of the same segment see their earlier
        same-chunk neighbours through the pages.  Only the valid lanes
        (wr_lanes, with their page/slot targets) write.

        A decode-batch member fuses in as one more segment holding a
        single lane: its current token at position ctx-1, emit lane set —
        the same write/attend/emit path that serves a finishing prompt
        serves a decode step, so prefill and decode share one call.

        emit_lanes (S,): the lane holding each segment's LAST token (clamped
        into range; rows of non-emitting segments are ignored by the host).
        Returns the (S, V) logits of those lanes."""
        cfg = self.cfg
        x = self.params.embed[tokens][None]               # (1, L, d)
        angles = rope_angles(positions[None], cfg.head_dim, cfg.rope_theta)

        def write(i, k, v):
            self.k_pages[i, wr_page, wr_slot] = k[0, wr_lanes]
            self.v_pages[i, wr_page, wr_slot] = v[0, wr_lanes]

        def attend(i, q):
            return ops.packed_prefill_attention(
                q[0], self.k_pages[i], self.v_pages[i], page_rows, seg_ids,
                positions, seg_ctx)

        x = self._layers(x, angles, write, attend)
        # one lm_head row per SEGMENT (S rows), not per lane
        return self._logits(x[0, emit_lanes])

    def _paged_decode_step(self, block_tables, ctx_lens, tokens, occ,
                           occ_rows, wr_page, wr_slot):
        """One token for every batch row.  ctx_lens INCLUDE the new token;
        its K/V is written at position ctx_lens-1 for the occupied rows
        only (occ_rows, with their page/slot targets).  ``occ`` (B,) bool
        marks real sequences: padded rows never write a page, reused or
        otherwise, and the kernel pins their attention output to zero, so
        padding needs no reserved scratch page.  Returns (B, V) logits."""
        cfg = self.cfg
        x = self.params.embed[tokens][:, None, :]         # (B, 1, d)
        angles = rope_angles((ctx_lens - 1)[:, None], cfg.head_dim,
                             cfg.rope_theta)

        def write(i, k, v):
            self.k_pages[i, wr_page, wr_slot] = k[occ_rows, 0]
            self.v_pages[i, wr_page, wr_slot] = v[occ_rows, 0]

        def attend(i, q):
            return ops.paged_attention(q[:, 0], self.k_pages[i],
                                       self.v_pages[i], block_tables,
                                       ctx_lens, occupancy=occ)

        x = self._layers(x, angles, write, attend)
        return self._logits(x[:, 0])

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
        """Drop a request that will never run: give back its hit pins."""
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
        migration-away).  The torch port has no host swap tier yet
        (ROADMAP A.6), so there is never a manifest to discard."""

    def _admit(self):
        """Admission reserves pages and enqueues — it NEVER runs model work,
        so a 4k-token prompt cannot stall the decode batch here.  The prompt
        is ingested chunk-by-chunk by :meth:`_step_locked` under the
        scheduler policy's token budget."""
        while len(self._active) + len(self._prefilling) < self.max_batch:
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
        total = len(req.prompt) + req.max_new_tokens
        n_pages_needed = -(-total // self.page_size)
        pages = list(req._hit_pages)
        owned_from = len(pages)
        for _ in range(n_pages_needed - len(pages)):
            pg = self.pool.try_alloc(req.req_id)
            if pg is None:
                break
            pages.append(pg)
        if len(pages) < n_pages_needed:
            # pool pressure: shed the eviction policy's quota for one
            # event, help reclamation, requeue ahead of peers
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
        req.status = "prefilling"
        self._prefilling.append(seq)
        return True

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
            n_valid = min(chunk, end - seq.filled)
            buf = np.zeros((chunk,), np.int64)
            buf[:n_valid] = req.prompt[seq.filled:seq.filled + n_valid]
            self._fault_dispatch()
            logits = self._paged_prefill(
                buf, seq.page_row, seq.filled, n_valid,
                emit=seq.filled + n_valid == n_prompt)
            seq.filled += n_valid
            self.prefill_chunks += 1
            self.prefill_tokens_wasted += chunk - n_valid
        if seq.filled == n_prompt:
            # final chunk: its last-position logits ARE the first token;
            # intermediate chunks never sync with the device
            tok, lp = ops.sample_tokens(logits,
                                        [req.sampling.temperature])
            self._finish_prefill(seq, int(tok.cpu()[0]), float(lp.cpu()[0]))

    def _finish_prefill(self, seq: _Seq, tok: int, lp: float = 0.0) -> None:
        """A sequence's prompt is fully in pages and its first token is in
        hand: stream it and move the sequence to decoding (or straight to
        done — a max_new_tokens=1 request must not overshoot to 2)."""
        req = seq.req
        self._prefilling.remove(seq)
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
        ``(L,)`` chunk with sequence-indicator segment ids, so the chunk
        budget buys C tokens of aggregate progress per kernel call instead
        of per sequence.  With chunked-style grants (sum ≤ C, ≤ max_batch
        sequences) one chunk per step suffices; the loop still splits
        defensively if a plan ever overflows C lanes or max_batch
        segments.

        FUSED STEP: ``riders`` is the step's active decode batch — each
        rider becomes one more segment holding exactly one lane (its
        current token at position ctx-1, emit lane set), so the step's
        decode tokens come out of the SAME device call as the prefill
        chunk.  The lane axis is C + max_batch wide so riders never eat
        into the prefill token budget (active + prefilling share
        max_batch, so segments always fit).  Riders ride the FIRST chunk
        only; returns their (next tokens, logprobs) pair of (n_riders,)
        arrays, or None when the plan was empty (caller falls back to the
        dedicated decode batch).

        The segment axis is BUCKETED to the next power of two above the
        actual segment count (1/2/4/.../max_batch): attention cost scales
        with S·max_pages keys in the plain version, so a 1-segment chunk
        must not pay the max_batch-wide rectangle."""
        chunk = self.config.prefill_chunk_tokens
        lanes_max = chunk + self.max_batch
        n_segs = self.max_batch
        pgsz = self.page_size
        queue = [(seq, grant) for seq, grant in plan if grant > 0]
        rider_toks = None
        first = True
        while queue:
            toks = np.zeros((lanes_max,), np.int64)
            segs = np.full((lanes_max,), -1, np.int32)
            poss = np.zeros((lanes_max,), np.int32)
            # per-lane write targets (padding lanes write nothing)
            upd = np.zeros((lanes_max,), np.int64)
            slot = np.zeros((lanes_max,), np.int64)
            rows = np.zeros((n_segs, self.max_pages), np.int32)
            ctxs = np.zeros((n_segs,), np.int32)
            emit = np.full((n_segs,), lanes_max, np.int32)  # not finishing
            temps = np.zeros((n_segs,), np.float32)
            members = []
            lane = 0
            budget = len(riders) if first else 0
            while queue and lane < chunk and len(members) + budget < n_segs:
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
                temps[si] = seq.req.sampling.temperature
                if seq.filled + take == len(seq.req.prompt):
                    emit[si] = lane + take - 1
                members.append((seq, take))
                lane += take
                if take < grant:
                    # chunk overflow: the remainder LEADS the next chunk.
                    # A mid-chunk split point need not be page-aligned —
                    # alignment only matters at STEP end (prefix-cache
                    # resume), and the full grant lands within this plan.
                    queue.insert(0, (seq, grant - take))
            n_riders = 0
            if first:
                for seq in riders:
                    si = len(members) + n_riders
                    ctx = len(seq.tokens)
                    toks[lane] = seq.tokens[-1]
                    segs[lane] = si
                    poss[lane] = ctx - 1
                    upd[lane] = seq.page_row[(ctx - 1) // pgsz]
                    slot[lane] = (ctx - 1) % pgsz
                    rows[si] = seq.page_row
                    ctxs[si] = ctx
                    temps[si] = seq.req.sampling.temperature
                    emit[si] = lane
                    n_riders += 1
                    lane += 1
            self.prefill_chunks += 1
            self.packed_chunks += 1
            self.packed_segments += len(members)
            self.prefill_tokens_wasted += chunk - (lane - n_riders)
            total = len(members) + n_riders
            self._fault_dispatch()
            # power-of-2 segment bucket: pay for the segments actually
            # present, not max_batch (seg ids are compact, so a prefix
            # slice of the per-segment operands is sufficient)
            n_b = min(n_segs, 1 << max(0, total - 1).bit_length())
            wr = np.flatnonzero(segs >= 0)
            logits = self._paged_prefill_packed(
                self._to_dev(toks), self._to_dev(segs), self._to_dev(poss),
                self._to_dev(rows[:n_b]), self._to_dev(ctxs[:n_b]),
                self._to_dev(np.clip(emit[:n_b], 0, lanes_max - 1)
                             .astype(np.int64)),
                self._to_dev(wr), self._to_dev(upd[wr]),
                self._to_dev(slot[wr]))
            finishing = any(emit[si] < lanes_max
                            for si in range(len(members)))
            # only a chunk that emits tokens (some prompt completed, or
            # decode riders aboard) syncs with the device
            out_np = lps_np = None
            if finishing or n_riders:
                out_toks, out_lps = ops.sample_tokens(logits, temps[:n_b])
                out_np = out_toks.cpu().numpy()
                lps_np = out_lps.cpu().numpy()
            for si, (seq, take) in enumerate(members):
                seq.filled += take
                if emit[si] < lanes_max:
                    self._finish_prefill(seq, int(out_np[si]),
                                         float(lps_np[si]))
            if n_riders:
                rider_toks = (
                    out_np[len(members):len(members) + n_riders],
                    lps_np[len(members):len(members) + n_riders])
            first = False
        return rider_toks

    def _decode_batch(self, batch_seqs):
        """The dedicated decode step for ``batch_seqs`` (padded to
        max_batch rows) → (next tokens, logprobs) as host arrays."""
        b = self.max_batch
        bt = np.zeros((b, self.max_pages), np.int32)
        ctx = np.ones((b,), np.int32)
        toks = np.zeros((b,), np.int64)
        occ = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        for i, seq in enumerate(batch_seqs):
            bt[i, :] = seq.page_row
            ctx[i] = len(seq.tokens)
            toks[i] = seq.tokens[-1]
            occ[i] = True
            temps[i] = seq.req.sampling.temperature
        n = len(batch_seqs)
        pos = ctx[:n] - 1
        wr_page = bt[np.arange(n), pos // self.page_size].astype(np.int64)
        self._fault_dispatch()
        logits = self._paged_decode_step(
            self._to_dev(bt), self._to_dev(ctx), self._to_dev(toks),
            self._to_dev(occ), self._to_dev(np.arange(n)),
            self._to_dev(wr_page),
            self._to_dev((pos % self.page_size).astype(np.int64)))
        out_toks, out_lps = ops.sample_tokens(logits, temps)
        return out_toks.cpu().numpy(), out_lps.cpu().numpy()

    def _release_seq(self, seq: _Seq) -> None:
        for pg in seq.pages[seq.owned_from:]:
            self.pool.release(pg)
        for pg in seq.pages[:seq.owned_from]:  # drop admission pins
            self.pool.unpin(pg)

    def _finish(self, seq: _Seq, status: str = "done"):
        if seq.req.done.is_set():
            # the watchdog already failed this handle out (unstealable
            # crash path: status/counters stamped, ``cancelled`` set so
            # we reap it here) — just give the pages back
            self._release_seq(seq)
            return
        # cache this sequence's page-aligned prefix (cancelled sequences are
        # not worth caching — their generation was cut short), then release
        # ownership
        if status == "done":
            self.prefix_cache.insert(seq.tokens, seq.pages)
            self.n_completed += 1
        elif status == "cancelled":
            self.n_cancelled += 1
        else:
            self.n_failed += 1
        self._release_seq(seq)
        seq.req.status = status
        seq.req._progress.set()
        seq.req.done.set()

    def step(self) -> bool:
        """One engine iteration; returns False when idle."""
        with self._step_lock, torch.inference_mode():
            return self._step_locked()

    def _step_locked(self) -> bool:
        self._sweep_deadlines()
        self._admit()
        if not self._active and not self._prefilling:
            return False
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
            if getattr(self.scheduler, "packs", False):
                # packed path: the WHOLE plan rides one fixed-shape chunk,
                # and the step's decode batch rides it too (fused step) —
                # sequences activated DURING this call decode next step
                batch_seqs = list(self._active)
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
            batch_seqs = list(self._active)
            decoded = self._decode_batch(batch_seqs)
        if decoded is not None:
            next_toks, next_lps = decoded
            done = []
            for i, seq in enumerate(batch_seqs):
                self._emit(seq, int(next_toks[i]), float(next_lps[i]))
                seq.new_tokens += 1
                if seq.new_tokens >= seq.req.max_new_tokens \
                        or seq.req.cancelled.is_set() or seq.req._stop_hit:
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

    def stats(self):
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
            # the swap tier and speculative decoding are not ported yet
            # (ROADMAP A.6, A.7): their counters stay 0
            "preemptions": 0,
            "resumed": 0,
            "slo_cancelled": self.n_slo_cancelled,
            "itl_slo_violations": self.n_itl_violations,
            "gap_intervals": self.n_gap_intervals,
            "gap_seconds": self.gap_seconds,
            "draft_proposed": 0,
            "draft_accepted": 0,
            "accept_rate": 0.0,
            "swap": None,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_wasted": self.prefill_tokens_wasted,
            "packed_chunks": self.packed_chunks,
            "packed_segments": self.packed_segments,
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
        }
