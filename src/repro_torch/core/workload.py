"""The paper's §5 benchmark driver.

Prefill the structure with 50% of the key range, then run N threads for a
fixed duration issuing a read/insert/delete mix.  Reports throughput
(Mops/s), memory overhead (average not-yet-reclaimed objects, sampled
periodically as in the paper), and the mechanism counters that are
thread-count independent (restarts, validation failures, barriers).

Workloads match the paper: ``50r-50w`` (50% read, 25% ins, 25% del),
``90r-10w`` (90/5/5), ``0r-100w`` (0/50/50).
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import build
from .smr import SmrScheme

WORKLOADS = {
    "50r-50w": (0.50, 0.25, 0.25),
    "90r-10w": (0.90, 0.05, 0.05),
    "0r-100w": (0.00, 0.50, 0.50),
}


@dataclass
class WorkloadResult:
    structure: str
    scheme: str
    threads: int
    key_range: int
    workload: str
    duration_s: float
    total_ops: int
    mops_per_s: float
    avg_not_reclaimed: float
    max_not_reclaimed: int
    smr_stats: Dict[str, int] = field(default_factory=dict)
    ds_stats: Dict[str, int] = field(default_factory=dict)
    batch_size: int = 1  # 1 = op-at-a-time; >1 = *_many batched driver
    traversal: str = ""  # resolved TraversalPolicy name

    def row(self) -> str:
        return (
            f"{self.structure},{self.scheme},{self.threads},{self.key_range},"
            f"{self.workload},{self.total_ops},{self.mops_per_s:.4f},"
            f"{self.avg_not_reclaimed:.1f},{self.max_not_reclaimed}"
        )


def run_workload(
    structure: str = "HList",
    scheme: str = "EBR",
    threads: int = 4,
    key_range: int = 512,
    workload: str = "50r-50w",
    duration_s: float = 1.0,
    seed: int = 0,
    sample_interval_s: float = 0.05,
    structure_kwargs: Optional[dict] = None,
    scheme_kwargs: Optional[dict] = None,
    batch_size: int = 1,
    traversal=None,
) -> WorkloadResult:
    read_p, ins_p, _ = WORKLOADS[workload]
    # the ONLY construction path: the facade negotiates (structure, scheme,
    # traversal) and raises IncompatiblePairError on illegal grids
    ds = build(structure=structure, smr=scheme, traversal=traversal,
               smr_kwargs=scheme_kwargs, **(structure_kwargs or {}))
    smr: SmrScheme = ds.smr

    # prefill with 50% of the key range (paper §5)
    rng = random.Random(seed)
    keys = list(range(key_range))
    rng.shuffle(keys)
    for k in keys[: key_range // 2]:
        ds.insert(k)

    stop = threading.Event()
    ready = threading.Barrier(threads + 1)
    ops = [0] * threads

    def worker(idx: int) -> None:
        r = random.Random(seed * 7919 + idx)
        # hoist hot attribute lookups: the loop body should measure the
        # structure + SMR substrate, not repeated bound-method resolution
        randrange, rand = r.randrange, r.random
        search, insert, delete = ds.search, ds.insert, ds.delete
        stopped = stop.is_set
        write_p = read_p + ins_p
        local_ops = 0
        ready.wait()
        while not stopped():
            k = randrange(key_range)
            p = rand()
            if p < read_p:
                search(k)
            elif p < write_p:
                insert(k)
            else:
                delete(k)
            local_ops += 1
        ops[idx] = local_ops

    def worker_batched(idx: int) -> None:
        """Batched driver mode (DESIGN.md §4): each round draws
        ``batch_size`` (key, op) pairs from the same mix, partitions them by
        op, and issues them through the *_many entry points — one guard
        scope and a resumed traversal per op group instead of one scope and
        one head-restart per key."""
        r = random.Random(seed * 7919 + idx)
        randrange, rand = r.randrange, r.random
        search_many = ds.search_many
        insert_many = ds.insert_many
        delete_many = ds.delete_many
        stopped = stop.is_set
        write_p = read_p + ins_p
        local_ops = 0
        ready.wait()
        while not stopped():
            reads: List[int] = []
            inserts: List[int] = []
            deletes: List[int] = []
            for _ in range(batch_size):
                k = randrange(key_range)
                p = rand()
                if p < read_p:
                    reads.append(k)
                elif p < write_p:
                    inserts.append(k)
                else:
                    deletes.append(k)
            if reads:
                search_many(reads)
            if inserts:
                insert_many(inserts)
            if deletes:
                delete_many(deletes)
            local_ops += batch_size
        ops[idx] = local_ops

    if batch_size > 1:
        worker = worker_batched

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(threads)]
    for t in ts:
        t.start()
    ready.wait()
    t0 = time.perf_counter()
    samples: List[int] = []
    deadline = t0 + duration_s
    while time.perf_counter() < deadline:
        time.sleep(min(sample_interval_s, max(0.0, deadline - time.perf_counter())))
        samples.append(smr.not_yet_reclaimed())
    stop.set()
    for t in ts:
        t.join()
    elapsed = time.perf_counter() - t0

    total = sum(ops)
    return WorkloadResult(
        structure=structure,
        scheme=scheme,
        threads=threads,
        key_range=key_range,
        workload=workload,
        duration_s=elapsed,
        total_ops=total,
        mops_per_s=total / elapsed / 1e6,
        avg_not_reclaimed=(sum(samples) / len(samples)) if samples else 0.0,
        max_not_reclaimed=max(samples) if samples else 0,
        smr_stats=smr.stats(),
        ds_stats=ds.stats() if hasattr(ds, "stats") else {},
        batch_size=batch_size,
        traversal=ds.policy.name,
    )


CSV_HEADER = ("structure,scheme,threads,key_range,workload,total_ops,"
              "mops_per_s,avg_not_reclaimed,max_not_reclaimed")


# --------------------------------------------------------------- serving
def _pctl(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 if empty):
    index ceil(q*N)-1, so q=0.99 over 100 samples is the 99th value, not
    the maximum."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


@dataclass
class ServingWorkloadResult:
    """One serving-session drive: throughput, tail latency (TTFT /
    inter-token), and the session's stats snapshot."""

    requests: int
    tokens: int
    duration_s: float
    tok_per_s: float
    prefix_hits: int
    incomplete: int                     # handles not done at the deadline
    # latency surface (seconds; 0.0 when the session's handles don't carry
    # the Request timestamp fields — duck-typed sessions)
    ttft_avg_s: float = 0.0             # submit → first token, mean
    ttft_p99_s: float = 0.0
    itl_avg_s: float = 0.0              # between consecutive tokens, mean
    itl_p99_s: float = 0.0              # the chunked-prefill headline: one
    #                                     admitted long prompt must not push
    #                                     this past ~one chunk's work
    # fault-tolerance surface (serving sessions with a watchdog; zeros for
    # duck-typed sessions without the totals counters)
    failed: int = 0                     # requests terminally failed
    cancelled: int = 0                  # incl. deadline-expired requests
    migrations: int = 0                 # completed live handoffs
    heartbeat_misses: int = 0
    degraded_steps: int = 0
    # swap-tier surface (sessions with ServingConfig.swap_bytes; zeros
    # otherwise)
    preemptions: int = 0
    swapped_out: int = 0                # pages spilled to the host arena
    swapped_in: int = 0                 # pages restored to device
    # per-priority-class breakdown (requests submitted with a class):
    # name -> {requests, completed, cancelled, failed, tokens, ttft_avg_s,
    # ttft_p99_s} — how each SLO class fared under the same contention
    per_class: Dict[str, Dict[str, float]] = field(default_factory=dict)
    session_stats: Dict = field(default_factory=dict)

    def row(self) -> str:
        return (f"requests={self.requests},tokens={self.tokens},"
                f"tok_s={self.tok_per_s:.1f},hits={self.prefix_hits},"
                f"ttft_p99_ms={self.ttft_p99_s * 1e3:.1f},"
                f"itl_p99_ms={self.itl_p99_s * 1e3:.1f}")


def run_serving_workload(
    session,
    n_requests: int = 12,
    clients: int = 3,
    shared_prefix_len: int = 16,
    tail_len: int = 4,
    distinct_prefixes: int = 1,
    max_new_tokens: int = 8,
    seed: int = 0,
    timeout_s: float = 300.0,
    wait_each: bool = False,
    prompts: Optional[List[List[int]]] = None,
    long_prompts: int = 0,
    long_prompt_len: int = 0,
    pace_s: float = 0.0,
    priority_classes: Optional[List[Optional[str]]] = None,
    max_new_tokens_per: Optional[List[int]] = None,
    swallow_errors: bool = False,
    sampling=None,
) -> ServingWorkloadResult:
    """Drive a serving session with concurrent client threads — the serving
    analogue of :func:`run_workload` (one shared request-mix loop instead of
    a copy in every example/benchmark/test).

    ``session`` is duck-typed: anything with ``submit(prompt,
    max_new_tokens=...) -> handle-with-done`` and ``stats()`` works (a
    :class:`repro.serving.ServingSession` in practice).  Prompts draw from
    ``distinct_prefixes`` shared prefixes (page-aligned reuse *and*, with
    more than one, shard spread under the prefix router) plus a random tail.

    ``wait_each=True`` makes every client wait for each request before
    submitting the next (prefix lookups then see earlier completions —
    cross-request cache hits become visible); the default submits each
    client's whole slice up front (maximum queueing pressure, the
    throughput-scaling configuration).  ``prompts=`` overrides the
    generated mix entirely (e.g. router-balanced prompts for the sharded
    smoke).

    ``long_prompts``/``long_prompt_len`` turn the mix into the
    chunked-prefill interference workload: that many random
    ``long_prompt_len``-token prompts are interleaved through the short
    shared-prefix requests, so their prefill lands while other sequences
    decode — the configuration whose TTFT and p99 inter-token latency
    :mod:`benchmarks.bench_serving` reports.

    ``pace_s`` is the fault-schedule mode: each client sleeps that long
    between submissions, stretching the run so a mid-run fault
    (``ServingConfig.faults`` — a stalled shard, say) lands while traffic
    is still ARRIVING, not after everything queued up front.  The result's
    ``failed``/``cancelled``/``migrations``/``heartbeat_misses``/
    ``degraded_steps`` fields then show what the watchdog did about it.

    ``priority_classes`` / ``max_new_tokens_per`` (each aligned with the
    final prompt list) give every request its own SLO class and decode
    budget — the oversubscription mix: long low-priority decoders flooding
    the pool while short high-SLO requests arrive on top.  The result's
    ``per_class`` dict then breaks outcomes and TTFT down per class.
    ``swallow_errors=True`` records submit-time rejections as cancelled
    instead of raising (an oversubscribed run REJECTING work is a result,
    not a driver bug).

    ``sampling`` is passed through to every ``submit`` call (a policy
    name like ``"temperature"`` or a ``SamplingPolicy`` instance).  A
    shared instance shares its seed across requests, which is fine —
    the counter PRNG keys on absolute position per request, so every
    request is still individually replay-exact."""
    rng = random.Random(seed)
    if prompts is None:
        prefixes = [[rng.randrange(1, 200) for _ in range(shared_prefix_len)]
                    for _ in range(max(1, distinct_prefixes))]
        prompts = [prefixes[i % len(prefixes)] +
                   [rng.randrange(1, 200) for _ in range(tail_len)]
                   for i in range(n_requests)]
        if long_prompts and long_prompt_len:
            stride = max(1, len(prompts) // (long_prompts + 1))
            for j in range(long_prompts):
                prompts.insert(
                    min(len(prompts), (j + 1) * stride + j),
                    [rng.randrange(1, 200) for _ in range(long_prompt_len)])
            n_requests = len(prompts)
    else:
        n_requests = len(prompts)

    if priority_classes is not None and \
            len(priority_classes) != len(prompts):
        raise ValueError(f"priority_classes has {len(priority_classes)} "
                         f"entries for {len(prompts)} prompts")
    if max_new_tokens_per is not None and \
            len(max_new_tokens_per) != len(prompts):
        raise ValueError(f"max_new_tokens_per has "
                         f"{len(max_new_tokens_per)} entries for "
                         f"{len(prompts)} prompts")

    handles: List = []
    rejected = [0]
    errors: List[BaseException] = []
    hlock = threading.Lock()
    ready = threading.Barrier(clients + 1)

    def client(cid: int) -> None:
        mine = list(range(cid, len(prompts), clients))
        ready.wait()
        local = []
        try:
            for i in mine:
                kwargs = {"max_new_tokens": (max_new_tokens_per[i]
                                             if max_new_tokens_per is not None
                                             else max_new_tokens)}
                if priority_classes is not None and \
                        priority_classes[i] is not None:
                    kwargs["priority_class"] = priority_classes[i]
                if sampling is not None:
                    kwargs["sampling"] = sampling
                try:
                    h = session.submit(prompts[i], **kwargs)
                except RuntimeError:
                    if not swallow_errors:
                        raise
                    with hlock:
                        rejected[0] += 1
                    continue
                local.append(h)
                if wait_each:
                    h.done.wait(timeout=timeout_s)
                if pace_s:
                    time.sleep(pace_s)
        except BaseException as e:       # surfaced after join — a silently
            with hlock:                  # dead client would otherwise just
                errors.append(e)         # shrink the reported request count
        finally:
            with hlock:
                handles.extend(local)
            for h in local:
                h.done.wait(timeout=timeout_s)

    ts = [threading.Thread(target=client, args=(i,), daemon=True)
          for i in range(clients)]
    for t in ts:
        t.start()
    ready.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join(timeout=timeout_s)
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]

    tokens = sum(len(h.out_tokens) for h in handles)
    incomplete = sum(0 if h.done.is_set() else 1 for h in handles)
    stats = session.stats() if hasattr(session, "stats") else {}
    totals = stats.get("totals", {})
    hits = totals.get("prefix_hits",
                      stats.get("prefix_cache", {}).get("hits", 0))
    # latency aggregation off the handles' Request timestamps (duck-typed:
    # a session whose handles don't expose ttft()/itl() reports zeros)
    ttfts = sorted(t for t in (h.ttft() for h in handles
                               if hasattr(h, "ttft")) if t is not None)
    itls = sorted(d for h in handles if hasattr(h, "itl") for d in h.itl())
    # per-priority-class breakdown (handles carrying a classed Request)
    per_class: Dict[str, Dict[str, float]] = {}
    for h in handles:
        cls = getattr(getattr(h, "req", None), "priority_class", None)
        if cls is None:
            continue
        agg = per_class.setdefault(cls, {
            "requests": 0, "completed": 0, "cancelled": 0, "failed": 0,
            "tokens": 0, "_ttfts": []})
        agg["requests"] += 1
        agg["tokens"] += len(h.out_tokens)
        if h.status in ("completed", "done"):
            agg["completed"] += 1
        elif h.status == "cancelled":
            agg["cancelled"] += 1
        elif h.status == "failed":
            agg["failed"] += 1
        t = h.ttft() if hasattr(h, "ttft") else None
        if t is not None:
            agg["_ttfts"].append(t)
    for agg in per_class.values():
        ts2 = sorted(agg.pop("_ttfts"))
        agg["ttft_avg_s"] = sum(ts2) / len(ts2) if ts2 else 0.0
        agg["ttft_p99_s"] = _pctl(ts2, 0.99)
    return ServingWorkloadResult(
        requests=len(handles),
        tokens=tokens,
        duration_s=elapsed,
        tok_per_s=tokens / elapsed if elapsed > 0 else 0.0,
        prefix_hits=int(hits),
        incomplete=incomplete,
        ttft_avg_s=sum(ttfts) / len(ttfts) if ttfts else 0.0,
        ttft_p99_s=_pctl(ttfts, 0.99),
        itl_avg_s=sum(itls) / len(itls) if itls else 0.0,
        itl_p99_s=_pctl(itls, 0.99),
        failed=int(totals.get("failed", 0)),
        cancelled=int(totals.get("cancelled", 0)) + rejected[0],
        migrations=int(totals.get("migrations", 0)),
        heartbeat_misses=int(totals.get("heartbeat_misses", 0)),
        degraded_steps=int(totals.get("degraded_steps", 0)),
        preemptions=int(totals.get("preemptions", 0)),
        swapped_out=int(totals.get("swapped_out", 0)),
        swapped_in=int(totals.get("swapped_in", 0)),
        per_class=per_class,
        session_stats=stats,
    )
