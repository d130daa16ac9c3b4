"""``ServingConfig`` — the one configuration surface for serving sessions.

Mirrors what :func:`repro.api.build` did for structure construction: every
knob the old ``PagedServingEngine(...)`` kwargs scattered is a named,
validated field here, and the new knobs (shards, SMR domain placement,
admission/eviction policies) are negotiated against their registries at
construction time — an unknown policy or scheme name fails in
``ServingConfig``, not three threads deep in an engine loop.

Torch port: there is no ``backend`` field (the kernels dispatch by the
device the session runs on).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .. import api

__all__ = ["ServingConfig", "PriorityClass", "parse_priority_class"]


@dataclass(frozen=True)
class PriorityClass:
    """One named service tier: its admission priority and (optional)
    latency SLOs.

    * ``priority`` feeds the ``priority`` admission policy ordering AND
      the swap tier's preemption rule (a waiting request may only preempt
      active sequences of *strictly lower* priority — DESIGN.md §15).
    * ``ttft_slo_s`` is ENFORCED: a request of this class that has not
      emitted its first token within the SLO is cancelled through the
      deadline sweep (overload sheds it instead of serving it late).
      Once the first token exists the TTFT SLO can no longer fire.
    * ``itl_slo_s`` is OBSERVED: inter-token gaps beyond it bump the
      ``itl_slo_violations`` stats counter (cancelling a decoding
      sequence mid-stream for one slow gap would waste its whole KV).
    """

    name: str
    priority: int = 0
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("priority class needs a non-empty name")
        if self.ttft_slo_s is not None and self.ttft_slo_s <= 0:
            raise ValueError(f"class {self.name!r}: ttft_slo_s must be > 0 "
                             f"or None, got {self.ttft_slo_s}")
        if self.itl_slo_s is not None and self.itl_slo_s <= 0:
            raise ValueError(f"class {self.name!r}: itl_slo_s must be > 0 "
                             f"or None, got {self.itl_slo_s}")


def parse_priority_class(spec: str) -> PriorityClass:
    """``"name:priority=10,ttft_slo_s=2.5"`` → :class:`PriorityClass`
    (the CLI surface: ``serve_paged --priority-class``)."""
    name, _, kvs = spec.partition(":")
    kwargs = {}
    if kvs:
        for part in kvs.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k == "priority":
                kwargs[k] = int(v)
            elif k in ("ttft_slo_s", "itl_slo_s"):
                kwargs[k] = float(v)
            else:
                raise ValueError(f"unknown priority-class field {k!r} in "
                                 f"{spec!r} (priority, ttft_slo_s, "
                                 f"itl_slo_s)")
    return PriorityClass(name=name.strip(), **kwargs)

# the engine's historical scheme tuning (frequent scans keep the page pool
# tight under serving churn); used when smr_kwargs is left empty
_DEFAULT_SMR_KWARGS: Dict[str, int] = {"retire_scan_freq": 16,
                                       "epoch_freq": 16}


@dataclass(frozen=True)
class ServingConfig:
    """Session-level serving configuration.

    Capacity fields (``num_pages``, ``max_batch``, ``prefix_cache_entries``)
    are **per shard**: a 2-shard session holds twice the pages and serves
    twice the decode batch of a 1-shard session with the same config.
    """

    # -- SMR domain --------------------------------------------------------
    smr: str = "IBR"                    # scheme registry name
    smr_kwargs: Optional[Dict] = None   # None → the serving default tuning
    shard_smr: str = "per_shard"        # "per_shard" | "shared"
    # free-list engine for each shard's BlockPool (DESIGN.md §16): any
    # reclaims=True scheme name runs alloc/free/reserve lock-free on a
    # Treiber stack under a dedicated instance of that scheme; "locked"
    # falls back to the mutex-guarded list.  Independent of `smr`
    # (which governs the pages/index structures, not the free list).
    pool_scheme: str = "VBR"

    # -- shape (per shard) -------------------------------------------------
    num_shards: int = 1
    num_pages: int = 256
    page_size: int = 8
    max_batch: int = 4
    max_seq_len: int = 256
    prefix_cache_entries: int = 128
    prefix_traversal: Optional[str] = None  # None → negotiated via repro.api

    # -- policies ----------------------------------------------------------
    admission: str = "fifo"             # "fifo" | "priority"
    eviction: str = "fifo"              # "fifo" | "pressure" | "lru" |
    #                                     "swap" (pressure + preemption to
    #                                     the host arena, DESIGN.md §15)
    scheduler: str = "chunked"          # "chunked" | "oneshot" |
    #                                     "roundrobin" | "packed"

    # -- host swap tier (DESIGN.md §15) ------------------------------------
    # host-side arena bytes PER SHARD backing the "swap" eviction policy:
    # when pressure eviction still cannot cover an admission, lower-priority
    # active sequences are preempted — K/V pages copied device→host into
    # the arena (copy + manifest recorded BEFORE the device pages are
    # retired through the SMR), request parked in the "swapped" status, and
    # resumed later bit-identically via prefill-from-offset.  0 disables
    # the tier (eviction="swap" then rejects at construction).
    swap_bytes: int = 0
    # named service tiers: a tuple of PriorityClass (or "name:k=v,..."
    # strings, normalized at construction).  submit(priority_class="x")
    # resolves the request's priority and TTFT/ITL SLOs against this table.
    priority_classes: Optional[Tuple] = None

    # -- speculative decoding (DESIGN.md §17) ------------------------------
    # draft depth per round: 0 disables speculation (every token comes
    # from the plain sampled decode step).  With spec_k > 0 each engine
    # round runs a draft proposal (spec_k tokens) plus ONE packed-chunk
    # verify call with fused on-device rejection sampling — every round
    # emits between 1 and spec_k+1 tokens per active row.
    spec_k: int = 0
    # draft construction: "auto" slices the served target (shared
    # embed/lm_head, first half of the blocks — models/registry.derive_draft)
    spec_draft: str = "auto"
    # layers kept by the sliced draft; 0 → half the target's (minimum 1)
    spec_draft_layers: int = 0

    # -- chunked prefill ---------------------------------------------------
    # per-step prefill token budget: each engine step advances at most this
    # many prompt tokens before the batched decode runs, so admitting a long
    # prompt delays in-flight decoders by one chunk, never one prompt.  Must
    # be a positive page multiple — chunk boundaries stay page-aligned so
    # resumed prefills line up with prefix-cache page runs (DESIGN.md §12).
    prefill_chunk_tokens: int = 64

    # -- loop pacing -------------------------------------------------------
    poll_s: float = 0.005               # engine-thread idle sleep
    janitor_interval_s: float = 0.02    # pressure-sweep period (watchdog)

    # -- fault tolerance (DESIGN.md §14) -----------------------------------
    # watchdog mode: "migrate" (default — degraded shards lose their router
    # slot AND their queued/prefilling/active sequences are live-migrated
    # to healthy shards), "observe" (degrade + stop routing only), "off"
    # (no watchdog: a stalled shard strands its requests; the pressure
    # sweep still runs).
    watchdog: str = "migrate"
    # a shard whose engine loop hasn't beaten for this long is degraded.
    # The default is deliberately generous: first-traffic device set-up
    # (library handles, allocator growth) happens INSIDE one step and must
    # not read as a stall on a slow box — chaos tests override it downwards.
    # The kernels themselves are built before the shard's thread starts.
    heartbeat_timeout_s: float = 10.0
    watchdog_interval_s: float = 0.05   # heartbeat-check period
    # live-sequence steal: step-lock acquisition timeout starts here and
    # doubles per failed sweep; after max_retries the crash path fails the
    # stranded handles out instead of letting clients hang.  The total
    # lock-wait budget is backoff * (2^retries - 1) — ~12.8s at the
    # defaults, sized to outlast slow first-traffic set-up (which runs
    # INSIDE a step, holding the step lock: such a shard looks exactly like
    # one wedged in a step, and must not get its requests failed out)
    migration_backoff_s: float = 0.05
    migration_max_retries: int = 8
    # per-request deadline applied when submit() passes no timeout_s;
    # None = requests never expire
    default_timeout_s: Optional[float] = None
    # chaos injection: a tuple of FaultSpec (or "kind:k=v,..." strings,
    # normalized at construction) — the seeded, reproducible fault plan
    # executed by each shard's engine loop (serving/faults.py)
    faults: Optional[Tuple] = None

    def __post_init__(self):
        from .policies import (  # late: avoids a cycle
            admission_policies,
            scheduler_policies,
        )
        from ..runtime.eviction import eviction_policies

        # raises ValueError on an unknown scheme name
        if not api.scheme_info(self.smr).reclaims:
            raise ValueError(
                f"scheme {self.smr!r} never reclaims — the page pool would "
                f"leak dry; choose from {api.schemes(reclaims=True)}")
        if self.pool_scheme != "locked":
            # raises ValueError on an unknown scheme name
            if not api.scheme_info(self.pool_scheme).reclaims:
                raise ValueError(
                    f"pool_scheme {self.pool_scheme!r} never reclaims — "
                    f"free-list cells would leak one per alloc; choose "
                    f"from {api.schemes(reclaims=True)} or 'locked'")
        if self.shard_smr not in ("per_shard", "shared"):
            raise ValueError("shard_smr must be 'per_shard' or 'shared', "
                             f"got {self.shard_smr!r}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        if self.page_size < 1 or self.num_pages < 2:
            raise ValueError("need page_size >= 1 and num_pages >= 2")
        if self.max_seq_len % self.page_size:
            raise ValueError(f"max_seq_len ({self.max_seq_len}) must be a "
                             f"multiple of page_size ({self.page_size})")
        if self.prefill_chunk_tokens < self.page_size or \
                self.prefill_chunk_tokens % self.page_size:
            raise ValueError(
                f"prefill_chunk_tokens ({self.prefill_chunk_tokens}) must "
                f"be a positive multiple of page_size ({self.page_size}): "
                f"chunk boundaries must stay page-aligned so resumed "
                f"prefills line up with prefix-cache page runs")
        if self.prefix_traversal is not None and \
                self.prefix_traversal not in api.traversal_policies():
            raise ValueError(
                f"unknown prefix_traversal {self.prefix_traversal!r}; "
                f"choose from {api.traversal_policies()}")
        if self.admission not in admission_policies():
            raise ValueError(f"unknown admission policy {self.admission!r};"
                             f" choose from {admission_policies()}")
        if self.eviction not in eviction_policies():
            raise ValueError(f"unknown eviction policy {self.eviction!r}; "
                             f"choose from {eviction_policies()}")
        if self.scheduler not in scheduler_policies():
            raise ValueError(f"unknown scheduler policy {self.scheduler!r};"
                             f" choose from {scheduler_policies()}")
        if self.swap_bytes < 0:
            raise ValueError(f"swap_bytes must be >= 0, got "
                             f"{self.swap_bytes}")
        if self.eviction == "swap" and self.swap_bytes == 0:
            raise ValueError(
                "eviction='swap' needs a host arena: set swap_bytes to the "
                "per-shard host budget (repro_torch.runtime.swap.page_nbytes "
                "sizes one page)")
        if self.priority_classes is not None:
            classes = tuple(parse_priority_class(c) if isinstance(c, str)
                            else c for c in self.priority_classes)
            for c in classes:
                if not isinstance(c, PriorityClass):
                    raise ValueError(
                        f"priority_classes entries must be PriorityClass "
                        f"or 'name:k=v' strings, got {c!r}")
            names = [c.name for c in classes]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate priority class names: {names}")
            object.__setattr__(self, "priority_classes", classes)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (0 = off), got "
                             f"{self.spec_k}")
        if self.spec_draft != "auto":
            raise ValueError(f"unknown spec_draft {self.spec_draft!r}; "
                             f"engine v1 only derives drafts ('auto')")
        if self.spec_draft_layers < 0:
            raise ValueError(f"spec_draft_layers must be >= 0 (0 = half "
                             f"the target), got {self.spec_draft_layers}")
        if self.watchdog not in ("migrate", "observe", "off"):
            raise ValueError(f"unknown watchdog mode {self.watchdog!r}; "
                             f"choose from ('migrate', 'observe', 'off')")
        if self.heartbeat_timeout_s <= 0 or self.watchdog_interval_s <= 0:
            raise ValueError("heartbeat_timeout_s and watchdog_interval_s "
                             "must be > 0")
        if self.migration_backoff_s <= 0 or self.migration_max_retries < 1:
            raise ValueError("need migration_backoff_s > 0 and "
                             "migration_max_retries >= 1")
        if self.default_timeout_s is not None and \
                self.default_timeout_s <= 0:
            raise ValueError(f"default_timeout_s must be > 0 or None, got "
                             f"{self.default_timeout_s}")
        if self.faults is not None:
            from .faults import FaultSpec, parse_fault  # late: avoids cycle
            specs = tuple(parse_fault(s) if isinstance(s, str) else s
                          for s in self.faults)
            for s in specs:
                if not isinstance(s, FaultSpec):
                    raise ValueError(f"faults entries must be FaultSpec or "
                                     f"'kind:k=v' strings, got {s!r}")
                if s.shard >= self.num_shards:
                    raise ValueError(
                        f"fault {s.kind!r} targets shard {s.shard} but the "
                        f"session has {self.num_shards} shard(s)")
            object.__setattr__(self, "faults", specs)

    # ---------------------------------------------------------------- utils
    @property
    def max_pages(self) -> int:
        return self.max_seq_len // self.page_size

    def priority_class(self, name: str) -> PriorityClass:
        """Resolve a class name (``submit(priority_class=...)``); raises
        ``ValueError`` on an unknown name — at submit, not mid-engine."""
        for c in (self.priority_classes or ()):
            if c.name == name:
                return c
        known = [c.name for c in (self.priority_classes or ())]
        raise ValueError(f"unknown priority class {name!r}; configured "
                         f"classes: {known}")

    def resolved_smr_kwargs(self) -> Dict:
        return dict(self.smr_kwargs) if self.smr_kwargs is not None \
            else dict(_DEFAULT_SMR_KWARGS)

    def build_scheme(self):
        """One fresh SMR domain (per-shard mode builds one per shard)."""
        return api.scheme(self.smr, **self.resolved_smr_kwargs())

    def replace(self, **changes) -> "ServingConfig":
        return dataclasses.replace(self, **changes)

    def summary(self) -> Dict[str, object]:
        """Flat snapshot embedded in ``session.stats()``."""
        return {
            "smr": self.smr,
            "shard_smr": self.shard_smr,
            "pool_scheme": self.pool_scheme,
            "num_shards": self.num_shards,
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "max_batch": self.max_batch,
            "max_seq_len": self.max_seq_len,
            "admission": self.admission,
            "eviction": self.eviction,
            "scheduler": self.scheduler,
            "swap_bytes": self.swap_bytes,
            "priority_classes": tuple(
                c.name for c in (self.priority_classes or ())),
            "spec_k": self.spec_k,
            "spec_draft": self.spec_draft,
            "spec_draft_layers": self.spec_draft_layers,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefix_traversal": self.prefix_traversal,
            "watchdog": self.watchdog,
            "default_timeout_s": self.default_timeout_s,
            "faults": tuple(f"{s.kind}@{s.shard}" for s in self.faults)
            if self.faults else (),
        }
