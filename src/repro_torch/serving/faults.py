"""Deterministic chaos injection for serving sessions — the fault registry.

The paper's robustness property is a statement about *faulty participants*:
a stalled or dead thread may pin O(K) objects, never unbounded memory, and
never another participant's progress.  To test that the serving layer
actually honors the same contract (DESIGN.md §14), faults must be
first-class and reproducible — a named registry mirroring the
scheduler/admission/eviction registries, wired through
``ServingConfig.faults`` and ``serve_paged --fault``, not ad-hoc
monkeypatching scattered through tests.

A :class:`FaultSpec` names one fault (registry ``kind``), the shard it
lands on, a trigger (``at_step`` in engine-loop beats, ``at_s`` seconds
after the engine loop starts, or ``after_done`` — the shard's completed
request count, the workload-deterministic trigger the chaos tests use to
fire strictly after jit warm-up traffic) and a window
(``duration_steps`` / ``duration_s``).  Kinds:

* ``stall`` — the shard's engine thread sleeps through the window (a
  descheduled/livelocked worker; the watchdog's bread and butter).
* ``crash`` — the engine thread raises :class:`InjectedFault` out of its
  run loop (the crash guard must fail every request out, not hang them).
* ``delay`` — every device dispatch in the window is delayed by
  ``delay_s`` (jittered by ``seed``): a slow device, not a dead thread —
  the watchdog must NOT degrade the shard for it.
* ``reader_stall`` — a helper thread takes an SMR guard on the shard's
  prefix-cache head and holds it through the window: the paper's stalled
  reader, pinning O(1) pages of one domain.
* ``pool_exhaust`` — every free page of the shard's pool is allocated at
  the trigger and held through the window: admission must requeue under
  pressure and resume afterwards, never wedge.

All triggers are evaluated on the shard's own loop counter/clock, so a
schedule replays identically under a fixed workload; ``seed`` only shapes
intra-window jitter (the ``delay`` kind).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

__all__ = [
    "FaultSpec",
    "InjectedFault",
    "FaultInjector",
    "StallFault",
    "CrashFault",
    "DelayFault",
    "ReaderStallFault",
    "PoolExhaustFault",
    "FAULT_KINDS",
    "fault_kinds",
    "parse_fault",
    "build_fault_line",
    "FaultLine",
]


class InjectedFault(RuntimeError):
    """Raised by the ``crash`` kind inside a shard's engine loop."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``at_step`` counts the shard's engine-loop
    beats (deterministic under a fixed workload); ``at_s`` is wall-clock
    after the loop starts (what the stalled-shard bench uses to stall the
    middle third of a run).  Exactly the set window applies: steps for
    ``duration_steps``, seconds for ``duration_s`` (steps win if both)."""

    kind: str
    shard: int = 0
    at_step: Optional[int] = None
    at_s: Optional[float] = None
    after_done: Optional[int] = None
    duration_steps: int = 0
    duration_s: float = 0.0
    delay_s: float = 0.0            # per-dispatch delay (kind="delay")
    seed: int = 0                   # intra-window jitter seed

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; choose "
                             f"from {fault_kinds()}")
        if self.shard < 0:
            raise ValueError(f"fault shard must be >= 0, got {self.shard}")
        if self.at_step is None and self.at_s is None \
                and self.after_done is None:
            # default: trigger on the first beat
            object.__setattr__(self, "at_step", 0)
        if self.duration_steps < 0 or self.duration_s < 0 or \
                self.delay_s < 0:
            raise ValueError("fault durations/delays must be >= 0")


def parse_fault(spec: str) -> FaultSpec:
    """``'kind:key=value,key=value'`` → :class:`FaultSpec` (the
    ``serve_paged --fault`` syntax), e.g.
    ``'stall:shard=0,at_step=50,duration_s=0.5'``."""
    kind, _, rest = spec.partition(":")
    kwargs: Dict[str, object] = {}
    if rest:
        for part in rest.split(","):
            if not part:
                continue
            k, _, v = part.partition("=")
            if not v:
                raise ValueError(f"fault option {part!r} needs key=value")
            if k in ("shard", "at_step", "after_done", "duration_steps",
                     "seed"):
                kwargs[k] = int(v)
            elif k in ("at_s", "duration_s", "delay_s"):
                kwargs[k] = float(v)
            else:
                raise ValueError(f"unknown fault option {k!r}")
    return FaultSpec(kind=kind, **kwargs)


class FaultInjector:
    """One armed fault on one shard.  Hook points (all called by the
    shard's own engine thread, except :meth:`release`):

    * ``before_step`` — once per engine-loop beat, OUTSIDE the step lock
      (a stall injected here models a descheduled thread between steps:
      the watchdog can still acquire the step lock and migrate);
    * ``on_dispatch`` — immediately before a device dispatch;
    * ``release`` — teardown (drain/crash/stop): give back anything held.
    """

    kind = "base"

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.fired = False
        self._t0: Optional[float] = None

    def on_start(self, engine) -> None:
        self._t0 = time.perf_counter()

    def _due(self, engine) -> bool:
        if self.fired:
            return False
        if self.spec.after_done is not None:
            return engine.n_completed >= self.spec.after_done
        if self.spec.at_step is not None:
            return engine.beat >= self.spec.at_step
        t0 = self._t0 if self._t0 is not None else time.perf_counter()
        return (time.perf_counter() - t0) >= self.spec.at_s

    def before_step(self, engine) -> None:  # pragma: no cover - interface
        pass

    def on_dispatch(self, engine) -> None:  # pragma: no cover - interface
        pass

    def release(self, engine) -> None:      # pragma: no cover - interface
        pass


class StallFault(FaultInjector):
    """Sleep the engine thread through the window (between steps — a
    descheduled worker, the watchdog-migration scenario)."""

    kind = "stall"

    def before_step(self, engine) -> None:
        if not self._due(engine):
            return
        self.fired = True
        if self.spec.duration_steps:
            # one missed step opportunity per configured beat
            for _ in range(self.spec.duration_steps):
                time.sleep(engine.config.poll_s)
        else:
            time.sleep(self.spec.duration_s)


class CrashFault(FaultInjector):
    """Raise out of the engine loop — the crash guard owns the cleanup."""

    kind = "crash"

    def before_step(self, engine) -> None:
        if not self._due(engine):
            return
        self.fired = True
        raise InjectedFault(
            f"injected crash on shard {engine.shard_id} at beat "
            f"{engine.beat} (FaultSpec seed={self.spec.seed})")


class DelayFault(FaultInjector):
    """Delay each device dispatch inside the window — a slow device, not a
    dead thread; the shard keeps beating and must NOT be degraded."""

    kind = "delay"

    def __init__(self, spec: FaultSpec):
        super().__init__(spec)
        self._rng = random.Random(spec.seed)
        self._open_t: Optional[float] = None
        self._open_beat: Optional[int] = None

    def _in_window(self, engine) -> bool:
        if not self.fired:
            if not self._due(engine):
                return False
            self.fired = True
            self._open_t = time.perf_counter()
            self._open_beat = engine.beat
        if self.spec.duration_steps:
            return engine.beat - self._open_beat < self.spec.duration_steps
        return (time.perf_counter() - self._open_t) < self.spec.duration_s

    def on_dispatch(self, engine) -> None:
        if self._in_window(engine):
            # seeded jitter: reproducible given the dispatch sequence
            time.sleep(self.spec.delay_s * (0.5 + self._rng.random()))


class ReaderStallFault(FaultInjector):
    """The paper's stalled reader: a helper thread protects the shard's
    prefix-cache bucket head under the shard's SMR scheme and holds the
    guard through the window — under a robust scheme it pins O(1) pages of
    THIS domain only, and the engine keeps serving."""

    kind = "reader_stall"

    def __init__(self, spec: FaultSpec):
        super().__init__(spec)
        self._release = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def before_step(self, engine) -> None:
        if not self._due(engine):
            return
        self.fired = True
        hold_s = self.spec.duration_s or \
            self.spec.duration_steps * engine.config.poll_s

        def stalled_reader():
            smr = engine.smr
            smr.begin_op()
            try:
                smr.protect(
                    engine.prefix_cache.buckets[0].head.next_ref(), 0)
                self._release.wait(timeout=hold_s)
            finally:
                smr.end_op()

        self._thread = threading.Thread(target=stalled_reader,
                                        name=f"fault-reader-{engine.shard_id}",
                                        daemon=True)
        self._thread.start()

    def release(self, engine) -> None:
        self._release.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class PoolExhaustFault(FaultInjector):
    """Allocate every free page at the trigger and hold them through the
    window: admission must shed eviction quota, requeue under pressure,
    and resume when the pages come back — never wedge or leak."""

    kind = "pool_exhaust"

    def __init__(self, spec: FaultSpec):
        super().__init__(spec)
        self._held: List = []
        self._open_t: Optional[float] = None
        self._open_beat: Optional[int] = None

    def before_step(self, engine) -> None:
        if not self.fired:
            if not self._due(engine):
                return
            self.fired = True
            self._open_t = time.perf_counter()
            self._open_beat = engine.beat
            while True:
                pg = engine.pool.try_alloc(None)
                if pg is None:
                    break
                self._held.append(pg)
            return
        if not self._held:
            return
        if self.spec.duration_steps:
            over = engine.beat - self._open_beat >= self.spec.duration_steps
        else:
            over = (time.perf_counter() - self._open_t) >= \
                self.spec.duration_s
        if over:
            self.release(engine)

    def release(self, engine) -> None:
        held, self._held = self._held, []
        for pg in held:
            engine.pool.release(pg)


FAULT_KINDS: Dict[str, Type[FaultInjector]] = {
    cls.kind: cls for cls in (StallFault, CrashFault, DelayFault,
                              ReaderStallFault, PoolExhaustFault)
}


def fault_kinds() -> List[str]:
    return list(FAULT_KINDS)


class FaultLine:
    """The faults armed on ONE shard (built from the session's plan).
    The engine calls the hooks unconditionally when a line exists; a shard
    with no scheduled faults carries ``None`` instead (zero hot-path
    cost)."""

    def __init__(self, injectors: Sequence[FaultInjector]):
        self.injectors = list(injectors)

    def on_start(self, engine) -> None:
        for inj in self.injectors:
            inj.on_start(engine)

    def before_step(self, engine) -> None:
        for inj in self.injectors:
            inj.before_step(engine)

    def on_dispatch(self, engine) -> None:
        for inj in self.injectors:
            inj.on_dispatch(engine)

    def release(self, engine) -> None:
        for inj in self.injectors:
            inj.release(engine)


def build_fault_line(
        faults: Optional[Sequence[Union[FaultSpec, str]]],
        shard_id: int) -> Optional[FaultLine]:
    """The specs scheduled for ``shard_id`` → a bound :class:`FaultLine`
    (fresh injector instances — lines are stateful), or ``None`` when the
    shard has no faults."""
    if not faults:
        return None
    mine = [parse_fault(s) if isinstance(s, str) else s
            for s in faults]
    mine = [s for s in mine if s.shard == shard_id]
    if not mine:
        return None
    return FaultLine([FAULT_KINDS[s.kind](s) for s in mine])
